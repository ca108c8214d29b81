"""Serve a MoE model on the PyTorch port: batched prefill + greedy decode
with the sliding-window ring cache (mixtral family).  The torch
counterpart of serve_moe.py.  Runs on the card unless ``--device cpu`` is
given.

    PYTHONPATH=src python examples/torch_serve_moe.py --device cpu
"""
import argparse

from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    extra = [] if args.device is None else ["--device", args.device]
    return serve.main(["--arch", "mixtral_8x7b", "--smoke", "--batch", "2",
                       "--prompt-len", "24", "--gen", "8", *extra])


if __name__ == "__main__":
    main()
