# Hand-written CUDA kernels of the port (sources under ../csrc), each
# beside its plain PyTorch version:
#   sdk_conv.py        - mapping-driven SDK convolution (launch steps = cycles)
#   im2win_conv.py     - mapping-free im2win convolution (blocks = n_cycles),
#                        behind ops.conv2d
#   tetris_matmul.py   - x (M, K) @ w (K, N), the matmul executor at G = 1,
#                        and the launch rule both matmuls share
#   grouped_matmul.py  - block-diagonal x (G, M, D) @ w (G, D, F), G > 1
#   flash_attention.py - online-softmax attention (the attention glue stage)
#   ssd_chunk.py       - Mamba-2 SSD intra-chunk product and chunk states
#                        (the ssd mixer's prefill)
#   matmul_exec.py     - the "matmul" plan executor over the two matmuls
#   ops.py             - the public wrappers (matmul, gmm, conv2d, attention)
#   ref.py             - the plain versions, gathered as oracles
#   _build.py          - nvcc build into build/kernels/, ctypes loading and
#                        the launch helper every wrapper calls
#   gemm_variants.py   - times edited copies of csrc/matmul.cu on the card
#                        (python -m repro_torch.kernels.gemm_variants)
