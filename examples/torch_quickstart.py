"""Quickstart on the PyTorch port: the paper's technique end to end.
The torch counterpart of quickstart.py.

1. map a conv layer with every algorithm and compare cycles;
2. execute the TetrisG mapping in PyTorch — the placement-batched
   reference executor (cim_conv2d) AND the macro-parallel executor
   (mapped_conv2d, executed grid steps == the mapping's cycle count) —
   and check both against F.conv2d;
3. run the macro-grid search (Alg 2), execute the whole mapped network,
   feed it to the CIM simulator, and print the summary table;
4. compile the network into one execution plan (repro_torch.exec) and run
   the same forward through it — bit-identical.

Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.cnn import (cim_conv2d, executed_steps, mapped_conv2d,
                             mapped_net_apply, reference_conv2d,
                             zero_pruned_kernels)
from repro_torch.core import (ALGORITHMS, ArrayConfig, ConvLayerSpec,
                              grid_search, map_layer, networks)
from repro_torch.core.simulator import simulate
from repro_torch.device import resolve_device
from repro_torch.exec import compile_plan, execute_plan


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    # --- 1. mapping: CNN8 layer 3 (the paper's Fig 12 example) ---------
    layer = ConvLayerSpec("CNN8-3", 18, 18, 3, 3, 32, 32)
    arr = ArrayConfig(512, 512)
    print(f"{layer.name} on a {arr.ar}x{arr.ac} CIM array:")
    for alg in ALGORITHMS:
        m = map_layer(layer, arr, alg)
        tiles = ", ".join(f"{t.window}x{t.ic_t}" for t in m.tiles)
        print(f"  {alg:12s} cycles={m.cycles:>3d} G={m.group} "
              f"tiles=[{tiles}]")

    # --- 2. the mapping actually computes the convolution --------------
    m = map_layer(layer, arr, "TetrisG-SDK")
    rng = np.random.RandomState(0)

    def randn(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32),
                               device=dev)
    x = randn(1, layer.ic, 18, 18)
    k = randn(3, 3, layer.ic // m.group, layer.oc)
    ref = reference_conv2d(layer, x, k, groups=m.group)
    err_cim = float((cim_conv2d(m, x, k) - ref).abs().max())
    err_map = float((mapped_conv2d(m, x, k) - ref).abs().max())
    print(f"\nreference executor  == F.conv2d (max err {err_cim:.1e})")
    print(f"macro-parallel path == F.conv2d (max err {err_map:.1e}), "
          f"executed steps {executed_steps(m)} == cycles {m.cycles}")

    # --- 3. Alg 2 grid search -> execute the mapped network -> simulate -
    res = grid_search("cnn8", networks.cnn8(), ArrayConfig(64, 64), p_max=8,
                      algorithm="TetrisG-SDK", groups=(1, 2, 4))
    net = res.best
    ks = zero_pruned_kernels(net, [
        randn(lm.layer.k_h, lm.layer.k_w, lm.layer.ic // lm.group,
              lm.layer.oc) * 0.1 for lm in net.layers])
    x0 = randn(1, 24, 18, 18)
    logits = mapped_net_apply(net, ks, x0)   # steps == cycles per layer
    sim = simulate(net)
    print(f"\nAlg 2 over 8x 64x64 macros -> best grid "
          f"{net.grid.r}x{net.grid.c}, {net.total_cycles} cycles, "
          f"EDAP {sim.edap:.2e} J*s*m^2, {sim.active_macros} active macros; "
          f"mapped forward out {tuple(logits.shape)}")

    # --- 4. compile the whole network into one execution plan ----------
    plan = compile_plan(net, executor_policy="mapped", device=dev)
    fused = execute_plan(plan, ks, x0)
    assert torch.equal(fused, logits), "plan forward must be bit-identical"
    print("\n" + plan.describe())
    print("\n" + net.summary())
    return max(err_cim, err_map)


if __name__ == "__main__":
    main()
