"""AdamW with f32 state over f32/bf16 parameters (port of
``repro/optim/adamw.py``).

Parameters, gradients and state are trees of dicts and lists with
tensors at the leaves, the shapes the JAX package's pytrees have.  The
update keeps the reference's association, ``p - lr*mh/(sqrt(vh)+eps)
- lr*wd*p`` in f32, so with :data:`repro_torch.cnn.train.ADAM` (decay
0, no clipping) it is bit-identical to a hand-rolled Adam.
``torch.optim.Adam`` folds the bias corrections into the step size and
would not be.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (and the same places of
    each tree in ``rest``), keeping the dict/list/tuple structure; dict
    entries go in sorted key order, so two trees with the same keys
    flatten alike whatever order their keys were inserted in."""
    if isinstance(tree, dict):          # keys in sorted order, as JAX
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensor leaves of ``tree``, in :func:`tree_map`'s order."""
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves: List[torch.Tensor]):
    """``leaves`` (in :func:`tree_leaves` order) in ``like``'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def adamw_init(params) -> Dict[str, Any]:
    def zeros32(p):         # a DTensor param's moments are sharded alike
        return torch.zeros_like(p, dtype=torch.float32)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros32, params), "v": tree_map(zeros32, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


@torch.no_grad()
def adamw_update(params, grads, opt_state, lr: float, cfg: AdamWConfig
                 ) -> Tuple[Any, Dict[str, Any], torch.Tensor]:
    """One AdamW step: returns (new params, new state, gradient norm).
    The new parameters are fresh tensors outside autograd; a trainer
    marks them ``requires_grad`` again."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = opt_state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    t = step.float()

    def upd(p, g, m, v):
        g32 = g.float()
        m_ = b1 * m + (1 - b1) * g32
        v_ = b2 * v + (1 - b2) * g32 * g32
        mh = m_ / (1 - b1 ** t)
        vh = v_ / (1 - b2 ** t)
        p32 = p.float()
        # decoupled weight decay as its own term: the Adam step keeps
        # the textbook association (module docstring)
        p_new = (p32 - lr * mh / (torch.sqrt(vh) + cfg.eps)
                 - lr * cfg.weight_decay * p32)
        return p_new.to(p.dtype), m_, v_

    out = [upd(*leaves) for leaves in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(opt_state["m"]),
        tree_leaves(opt_state["v"]))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out])
                           for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "step": step}, gnorm
