# Entry points of the port: serve_cnn.py (fixed-batch serving of CNNs and of
# lowered transformers), transformer.py (the transformer lowering),
# serve.py and steps.py (LM serving: a batched prefill, then greedy
# decode) and the batching helpers serving uses.
