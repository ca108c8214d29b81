"""The assigned input-shape grid and per-cell assembly (port of
``repro/launch/shapes.py``).

Every (arch x shape) cell resolves to a concrete (step fn, abstract args,
in/out shardings) tuple via :func:`build_cell`, as in the JAX package.
The abstract args are ``meta`` tensors with the JAX package's dtypes;
:func:`materialize` turns them into real tensors placed by the in
shardings (what the JAX package's ``jit(in_shardings=)`` does to its
concrete arrays), and the step fn places its results by the out
shardings.  On a ``DeviceMesh`` the placed tensors are ``DTensor``s; on
a one-device mesh (``launch.mesh.make_host_mesh``) they stay plain.

Shapes:
    train_4k     seq 4096,   global_batch 256   -> train_step
    prefill_32k  seq 32768,  global_batch 32    -> prefill_step
    decode_32k   seq 32768,  global_batch 128   -> serve_step (1 token,
                 cache filled to seq)
    long_500k    seq 524288, global_batch 1     -> serve_step; requires a
                 sub-quadratic arch (cfg.sub_quadratic) — full-attention
                 archs are skipped.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..models import transformer as T
from ..models.attention import attention_policy
from ..models.common import norm_policy
from ..models.config import ArchConfig
from . import sharding as sh
from .mesh import axis_sizes
from .sharding import NamedSharding, P
from .steps import (TrainConfig, init_train_state, make_prefill_step,
                    make_serve_step, make_train_step)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq: int
    batch: int
    mode: str           # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ArchConfig, shape: ShapeSpec
                   ) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full quadratic attention at 500k context — "
                       "skipped per brief; see DESIGN.md")
    return True, ""


def _sds(shape, dtype) -> torch.Tensor:
    """An abstract value: a ``meta`` tensor (``jax.ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeSpec, mesh
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(abstract batch, shardings) for a train/prefill batch."""
    b, s = shape.batch, shape.seq
    extra = 1 if shape.mode == "train" else 0      # +1 token for labels
    batch: Dict[str, Any] = {}
    shards: Dict[str, Any] = {}
    bd = sh.batch_dim(mesh, b)
    if cfg.frontend == "vision":
        batch["tokens"] = _sds((b, s - cfg.n_prefix + extra), torch.int32)
        batch["prefix_embeds"] = _sds((b, cfg.n_prefix, cfg.d_model),
                                      torch.bfloat16)
        shards["tokens"] = NamedSharding(mesh, P(bd, None))
        shards["prefix_embeds"] = NamedSharding(mesh, P(bd, None, None))
    else:
        batch["tokens"] = _sds((b, s + extra), torch.int32)
        shards["tokens"] = NamedSharding(mesh, P(bd, None))
    if cfg.kind == "encdec":
        batch["enc_embeds"] = _sds((b, s, cfg.d_model), torch.bfloat16)
        shards["enc_embeds"] = NamedSharding(mesh, P(bd, None, None))
    return batch, shards


def default_microbatches(cfg: ArchConfig, shape: ShapeSpec, mesh) -> int:
    """Grad-accumulation count: keep ~<=128k tokens per microbatch and
    divide the batch evenly."""
    target = max(1, (shape.batch * shape.seq) // 131072)
    n = 1
    for cand in (1, 2, 4, 8, 16, 32):
        if shape.batch % cand == 0 and cand <= target:
            n = cand
    return n


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, *,
               microbatches: Optional[int] = None,
               train_cfg: Optional[TrainConfig] = None,
               optimized: bool = True):
    """-> (fn, args_abstract: tuple, in_shardings, out_shardings).

    ``fn`` runs the cell's step under its mode's policy and places its
    results by ``out_shardings``; give it the args :func:`materialize`
    makes.  The policy (the JAX package's, by mode):

    * train: context-parallel scores for archs whose head count does not
      divide the model axis, the MoE gather-at-use, inner remat and bf16
      score storage; the bf16 norm chain, except with a recurrent
      (``rec``) mixer;
    * prefill: bf16 scores only;
    * decode: nothing.
    """
    params_shape = T.init_params(cfg, device="meta")
    param_sh = sh.param_shardings(cfg, params_shape, mesh)
    rep = sh.replicated(mesh)
    # the step computes on the mesh's 2-d view (pod folded into data;
    # sh.compute_mesh): the policies' shardings are the view's
    cmesh = sh.compute_mesh(mesh)
    bd_act = sh.batch_dim(cmesh, shape.batch)
    act_sh = NamedSharding(cmesh, P(bd_act, None, None))

    is_train = optimized and shape.mode == "train"
    has_rec = any(sp.mixer == "rec" for st in cfg.stages
                  for sp in st.unit)
    scores_sh = None
    cp_axis = None
    if is_train and cfg.n_heads and \
            cfg.n_heads % axis_sizes(mesh)["model"] != 0:
        scores_sh = NamedSharding(cmesh, P(bd_act, None, None, "model",
                                           None))
        cp_axis = (cmesh, bd_act)

    def with_policy(fn, out_sh):
        view_out = sh.view_shardings(out_sh, mesh)

        def wrapped(*a):
            with attention_policy(
                    scores_sharding=scores_sh, cp_axis=cp_axis,
                    scores_dtype=(torch.bfloat16 if optimized
                                  and shape.mode != "decode" else None),
                    inner_remat=is_train,
                    mesh=cmesh if is_train else None), \
                 norm_policy(fast=is_train and not has_rec), \
                 sh.spmd(mesh):
                out = sh.constrain_tree(fn(*sh.rewrap(a, cmesh)), view_out)
                return sh.rewrap(out, mesh)
        return wrapped

    if shape.mode == "train":
        n_mb = microbatches or default_microbatches(cfg, shape, mesh)
        tc = train_cfg or TrainConfig(microbatches=n_mb)
        state_shape = init_train_state(cfg, None, "meta")
        state_sh = {"params": param_sh,
                    "opt": sh.opt_shardings(param_sh, mesh)}
        batch, batch_sh = batch_specs(cfg, shape, mesh)
        metrics_sh = {"loss": rep, "grad_norm": rep, "lr": rep}
        out_sh = (state_sh, metrics_sh)
        fn = with_policy(make_train_step(cfg, tc, act_sharding=act_sh),
                         out_sh)
        return fn, (state_shape, batch), (state_sh, batch_sh), out_sh

    if shape.mode == "prefill":
        batch, batch_sh = batch_specs(cfg, shape, mesh)
        cache_shape = T.init_cache(cfg, shape.batch, shape.seq,
                                   enc_len=shape.seq, device="meta")
        cache_sh = sh.cache_shardings(cfg, cache_shape, mesh)
        bd = sh.batch_dim(mesh, shape.batch)
        out_sh = (NamedSharding(mesh, P(bd)), cache_sh)
        fn = with_policy(make_prefill_step(cfg, cache_len=shape.seq,
                                           act_sharding=act_sh), out_sh)
        return fn, (params_shape, batch), (param_sh, batch_sh), out_sh

    # decode
    cache_shape = T.init_cache(cfg, shape.batch, shape.seq,
                               enc_len=min(shape.seq, 32768), device="meta")
    cache_sh = sh.cache_shardings(cfg, cache_shape, mesh)
    bd = sh.batch_dim(mesh, shape.batch)
    token = _sds((shape.batch, 1), torch.int32)
    token_sh = NamedSharding(mesh, P(bd, None))
    pos = _sds((), torch.int32)
    out_sh = (token_sh, cache_sh)
    fn = with_policy(make_serve_step(cfg, act_sharding=act_sh), out_sh)
    return (fn, (params_shape, cache_shape, token, pos),
            (param_sh, cache_sh, token_sh, rep), out_sh)


def materialize(cfg: ArchConfig, shape: ShapeSpec, args, in_shardings, *,
                seed: int = 0, weights=None):
    """Real args for :func:`build_cell`'s fn, placed by ``in_shardings``.

    Params are drawn from ``torch.Generator(seed)`` by
    ``models.transformer.init_params`` (or carried from ``weights``, the
    JAX package's pytree as numpy, by ``models.params_from_numpy``);
    Adam's moments and step are zero; tokens are drawn uniformly below
    ``cfg.vocab`` and the embeddings (a vision prefix, encoder frames)
    from N(0, 1) in bf16, from ``seed + 1``; a decode cache is zero, its
    token drawn likewise, and its position the cache's last slot,
    ``shape.seq - 1``, a Python int.

    On a ``DeviceMesh`` every rank draws the same values and keeps its
    shards: the params block by block (``launch.sharding.Placer``), the
    batch whole; zeros are made as shards.  So a rank holds one block of
    the model in full beside its shards, never the whole train state."""
    from ..models.weights import params_from_numpy
    mesh = next(s.mesh for s in T.tree_leaves(in_shardings)
                if isinstance(s, NamedSharding))
    dev = sh.mesh_device(mesh)

    def params(shardings):
        placer = sh.Placer(shardings)
        if weights is not None:
            return placer.tree(params_from_numpy(cfg, weights, device="cpu"))
        gen = torch.Generator(device=dev).manual_seed(seed)
        return T.init_params(cfg, gen, dev, place=placer)

    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def draw(a, s):
        if a.dtype == torch.int32:
            x = torch.randint(0, cfg.vocab, tuple(a.shape), generator=gen,
                              device=dev, dtype=torch.int32)
        else:
            x = torch.randn(tuple(a.shape), generator=gen, device=dev,
                            dtype=torch.float32).to(a.dtype)
        return sh.place(x, s)

    def batch(abstract, shardings):
        return {k: draw(abstract[k], shardings[k]) for k in sorted(abstract)}

    if shape.mode == "train":
        (state_shape, b), (state_sh, b_sh) = args, in_shardings
        return ({"params": params(state_sh["params"]),
                 "opt": sh.zeros(state_shape["opt"], state_sh["opt"])},
                batch(b, b_sh))
    if shape.mode == "prefill":
        return params(in_shardings[0]), batch(args[1], in_shardings[1])
    return (params(in_shardings[0]), sh.zeros(args[1], in_shardings[1]),
            draw(args[2], in_shardings[2]), shape.seq - 1)
