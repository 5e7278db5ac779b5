"""Distribution techniques of the paper, as far as the port's one
device needs them: the padded, masked eval (C4) and batch norm in its
one-device form."""
