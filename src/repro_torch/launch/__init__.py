# Entry points of the port: serve_cnn.py (fixed-batch serving of CNNs and of
# lowered transformers), transformer.py (the transformer lowering),
# serve.py (LM serving: a batched prefill, then greedy decode), steps.py
# (the LM train, prefill and decode steps), train.py (the LM and plan
# trainers' CLI) and the batching helpers serving uses.
