# Hand-written CUDA kernels of the port (sources under ../csrc), each
# beside its plain PyTorch version:
#   sdk_conv.py        - mapping-driven SDK convolution (launch steps = cycles)
#   tetris_matmul.py   - x (M, K) @ w (K, N), the matmul executor at G = 1
#   grouped_matmul.py  - block-diagonal x (G, M, D) @ w (G, D, F), G > 1
#   flash_attention.py - online-softmax attention (the attention glue stage)
#   matmul_exec.py     - the "matmul" plan executor over the two matmuls
#   _build.py          - nvcc build into build/kernels/, ctypes loading and
#                        the launch helper every wrapper calls
