# Hand-written CUDA kernels of the port (sources under ../csrc), each
# beside its plain PyTorch version:
#   sdk_conv.py - mapping-driven SDK convolution (launch steps = cycles)
#   _build.py   - nvcc build into build/kernels/ and ctypes loading
