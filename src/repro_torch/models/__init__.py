"""Model code of the port: the decoder layers and the paged-serving LM,
the encoder-decoder, GNMT, ResNet v1.5, and the other MLPerf-0.6 models
(the Transformer, SSD and Mask R-CNN)."""
