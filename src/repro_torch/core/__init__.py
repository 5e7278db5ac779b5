"""Distribution techniques of the paper, as far as the port's one
device needs them: the padded, masked eval (C4), batch norm and graph
partitioning (C10) in their one-device forms."""
