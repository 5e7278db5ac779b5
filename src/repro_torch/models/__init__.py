"""Model code of the port: the decoder layers and the paged-serving LM,
GNMT, and ResNet v1.5."""
