"""End-to-end LM training on the PyTorch port: train mamba2-130m (or any
--arch) on the synthetic token stream with checkpoints, through
``repro_torch.launch.train``.  The torch counterpart of train_lm.py.

The default trains the smoke config; ``--full-arch`` trains the real
130M mamba2, the size this script is shaped for on the card.  Runs on the
card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_train_lm.py --device cpu
    PYTHONPATH=src python examples/torch_train_lm.py --full-arch \
        --steps 300 --batch 16
"""
import argparse

from repro_torch.launch import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_130m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full-arch", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    argv = ["--arch", args.arch, "--steps", str(args.steps),
            "--batch", str(args.batch), "--seq", str(args.seq),
            "--save-every", "100"]
    if not args.full_arch:
        argv.append("--smoke")
    if args.ckpt_dir is not None:
        argv += ["--ckpt-dir", args.ckpt_dir]
    if args.device is not None:
        argv += ["--device", args.device]
    return train.main(argv)


if __name__ == "__main__":
    main()
