"""The system under test, ``repro_torch``, as the benchmark drives it.

This is the one module of the benchmark that calls into the program:
the mapping search and the plan compiler at set-up, and the compiled
forward (``repro_torch.exec.execute_plan``) in the window.  Set-up
refuses a mapping whose groups or kept channels differ from the
configuration's pins, so that a change to the search cannot change the
function computed and be read as a change in speed."""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from . import counts


class PinMismatch(ValueError):
    """The program's mapping differs from the configuration's pins."""


def arch_config(cfg: dict):
    """The program's architecture for a transformer configuration: its
    registered config with the sizes the file states."""
    from repro_torch.configs import get_config
    t = counts.transformer_dims(cfg)
    arch = get_config(cfg["program_arch"])
    stage = arch.stages[0]
    return dataclasses.replace(
        arch, d_model=t["d"], n_heads=t["hq"], n_kv_heads=t["hkv"],
        head_dim=t["hd"], d_ff=t["ff"],
        stages=(dataclasses.replace(stage, n_units=t["layers"]
                                    // len(stage.unit)),))


def build_mapping(cfg: dict, traffic: dict):
    """Map the configuration with the program's search."""
    from repro_torch.core import ArrayConfig, ConvLayerSpec, map_net
    array = ArrayConfig(cfg["array_rows"], cfg["array_cols"])
    groups = tuple(cfg["search_groups"])
    if cfg["kind"] == "cnn":
        layers = [ConvLayerSpec(name=ly["name"], i_h=ly["i_h"],
                                i_w=ly["i_w"], k_h=ly["k_h"], k_w=ly["k_w"],
                                ic=ly["ic"], oc=ly["oc"],
                                stride=ly["stride"])
                  for ly in cfg["layers"]]
        return map_net(cfg["name"], layers, array, cfg["algorithm"],
                       groups=groups)
    if cfg["kind"] == "transformer":
        from repro_torch.launch.transformer import transformer_mapping
        return transformer_mapping(arch_config(cfg), seq=traffic["seq"],
                                   array=array, algorithm=cfg["algorithm"],
                                   groups=groups)
    raise ValueError(f"{cfg['name']}: unknown kind {cfg['kind']!r}")


def expected_layers(cfg: dict, traffic: dict) -> List[Tuple[str, dict, tuple]]:
    """(layer name, pin, (i_h, i_w, k_h, k_w, ic, oc)) of every mapped
    layer the configuration describes, in order."""
    if cfg["kind"] == "cnn":
        return [(ly["name"], cfg["pins"][ly["name"]],
                 (ly["i_h"], ly["i_w"], ly["k_h"], ly["k_w"], ly["ic"],
                  ly["oc"])) for ly in cfg["layers"]]
    t = counts.transformer_dims(cfg)
    return [(f"blk{i}.{kind}", cfg["pins"][kind],
             (traffic["seq"], 1, 1, 1, ic, oc))
            for i in range(t["layers"])
            for kind, ic, oc in counts.projections(cfg)]


def check_pins(cfg: dict, traffic: dict, mapping) -> None:
    """Raise :class:`PinMismatch` unless every layer of ``mapping`` has
    the configuration's geometry, group count and per-tile kept and
    pruned channels."""
    want = expected_layers(cfg, traffic)
    got = list(mapping.layers)
    problems = []
    if len(got) != len(want):
        problems.append(f"{len(got)} mapped layers, the configuration "
                        f"has {len(want)}")
    for (name, pin, geom), m in zip(want, got):
        ly = m.layer
        have = (ly.i_h, ly.i_w, ly.k_h, ly.k_w, ly.ic, ly.oc)
        tiles = [[t.depth, t.pruned_channels] for t in m.tiles]
        if ly.name != name or have != geom:
            problems.append(f"{ly.name} {have} where the configuration "
                            f"has {name} {geom}")
        if m.group != pin["group"] or tiles != pin["tiles"]:
            problems.append(f"{name}: group {m.group}, tiles {tiles}; "
                            f"pinned group {pin['group']}, tiles "
                            f"{pin['tiles']}")
    if problems:
        raise PinMismatch(f"{cfg['name']}: the mapping differs from the "
                          f"pins: " + "; ".join(problems))


def compile_plan(mapping, batch: int, device: torch.device):
    from repro_torch.exec import compile_plan as compile_
    return compile_(mapping, executor_policy="auto", batch=batch,
                    device=device)


def executors(plan) -> dict:
    """Layer name -> the executor the plan runs it on."""
    return {lp.mapping.layer.name: lp.executor for lp in plan.layers}


def forward_fn(plan, kernels, activation: str):
    """The timed call: one ``execute_plan`` of a batch."""
    from repro_torch.exec import execute_plan
    act = {"relu": torch.relu, "none": None}[activation]

    def forward(x: torch.Tensor) -> torch.Tensor:
        return execute_plan(plan, kernels, x, activation=act)
    return forward
