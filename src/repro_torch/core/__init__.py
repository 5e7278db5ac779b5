"""Distribution techniques of the paper, as far as the port's one
device needs them."""
