# Drivers of the port: serve_cnn.py (fixed-batch serving of CNNs and of
# lowered transformers), transformer.py (the transformer lowering) and
# the batching helpers serving uses.
