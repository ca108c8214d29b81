# Drivers of the port: serve_cnn.py (fixed-batch CNN serving) and the
# batching helpers it uses.
