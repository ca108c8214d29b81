"""Memory-model pass: per-layer live-byte estimates from the mapping IR.

Training differentiates through the whole fused forward (exec/run.py),
so without rematerialization every layer's saved input activation AND
its in-trace shifted-weight prep (the Fig-5 weight matrix blocks the
mapped/reference executors build from the kernel) are live at once for
the backward pass.  This pass prices both per layer, **from the
`LayerMapping` itself** — no tracing, no device allocation — so the
segmentation pass (exec/remat.py) can choose checkpoint boundaries and
`NetworkPlan.describe()` / the benches can report a peak estimate
without ever running the trainer.

Two numbers per layer (:class:`LayerMemory`):

* ``act_bytes`` — the input activation saved for the layer's backward:
  ``batch * carry_c * i_h * i_w * itemsize`` (``carry_c`` is the carry
  entering the layer — for DenseNet concat layers that is the full
  concatenated width, which is exactly why deep concat stacks blow up).
* ``weight_bytes`` — the layer's shifted-weight constant prep: the full
  Fig-5 matrix across every channel/oc pass of every tile, times the
  group count (groups are congruent but each has its own weights).  Per
  tile that is ``(ic_t*ar_c * pw_h*pw_w) x (positions * oc_t*ac_c)``
  floats — the executed pass structure (`LayerMapping.tile_passes`),
  not the stored one, so the estimate follows what the executor
  actually materializes.  Marginal-window matrices (strictly smaller
  than the regular placement's) are not added: this is an estimate used
  to *rank* boundaries, not an allocator.

The peak model (:func:`peak_bytes`) is the classic checkpointing one:
each segment boundary stores its carry activation for the whole
backward, and within the backward exactly one segment's layers are
re-materialized at a time —

    peak = max_over_segments(sum of layer bytes) + sum(boundary carries)

With one segment (remat off) this degenerates to the plain sum: every
layer live at once, the ``unremat_peak`` the ROADMAP item set out to
break.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

#: Activations / shifted-weight blocks are float32 throughout the
#: executors (cnn/cim_conv.py builds f32 matrices from f32 kernels).
ITEMSIZE = 4


@dataclass(frozen=True)
class LayerMemory:
    """Live-byte estimate of one planned layer (see module docstring)."""

    name: str
    act_bytes: int          # saved input activation (backward residual)
    weight_bytes: int       # shifted-weight constant prep (Fig 5 blocks)

    @property
    def total_bytes(self) -> int:
        return self.act_bytes + self.weight_bytes


def activation_bytes(mapping, carry_c: int, batch: int) -> int:
    """Input-activation bytes entering a layer: the tensor its backward
    needs saved (or rematerialized)."""
    lay = mapping.layer
    return batch * carry_c * lay.i_h * lay.i_w * ITEMSIZE


def weight_prep_bytes(mapping) -> int:
    """Shifted-weight-matrix bytes of one layer, from the executed pass
    structure: per tile ``rows = ic_t*ar_c * pw_h*pw_w`` and
    ``cols = positions * oc_t*ac_c`` (build_weight_matrix's shape,
    summed over passes), times the group count."""
    lay = mapping.layer
    total = 0
    for tile in mapping.tiles:
        ic_t, ar_c, oc_t, ac_c = mapping.tile_passes(tile)
        w = tile.window
        pos = w.positions(lay.k_w, lay.k_h, lay.stride)
        rows = ic_t * ar_c * w.pw_w * w.pw_h
        cols = pos * oc_t * ac_c
        total += rows * cols
    return total * mapping.group * ITEMSIZE


def layer_memory(mapping, carry_c: int, batch: int) -> LayerMemory:
    return LayerMemory(name=mapping.layer.name,
                       act_bytes=activation_bytes(mapping, carry_c, batch),
                       weight_bytes=weight_prep_bytes(mapping))


def network_memory(net, carries: Sequence[int],
                   batch: int) -> Tuple[LayerMemory, ...]:
    """Per-layer estimates for a whole mapping; ``carries`` is the
    carry channel count entering each layer (the glue pass's output)."""
    return tuple(layer_memory(m, c, batch)
                 for m, c in zip(net.layers, carries))


def peak_bytes(mem: Sequence[LayerMemory],
               segments: Sequence[Tuple[int, int]]) -> int:
    """Peak-byte estimate of a segmented plan (module docstring): the
    heaviest segment's layer bytes plus every boundary's stored carry —
    the carry entering a segment is the first layer's input activation,
    held live for the whole backward."""
    segs = list(segments)
    heaviest = max(sum(m.total_bytes for m in mem[s:e]) for s, e in segs)
    boundaries = sum(mem[s].act_bytes for s, _ in segs[1:])
    return heaviest + boundaries


def total_bytes(mem: Sequence[LayerMemory]) -> int:
    """The unremat'd peak: every layer's saved bytes live at once."""
    return sum(m.total_bytes for m in mem)
