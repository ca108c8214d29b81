"""The port's LM train step against the JAX package's in bf16 compute, the
type both train in, on the CPU at the six smoke configs of
test_torch_lm_train.py.

bf16 gradients do not match the JAX ones bit for bit, by form: JAX
differentiates ``cast(embed)[tokens]`` with a bf16 scatter-add where the
port gathers f32 rows and casts them (repeated tokens sum in f32), and
XLA's transposed bf16 dots round elsewhere than autograd's.  So the
gradients are held in f32 (test_torch_lm_train.py), and here the first
step's loss at the forwards' bf16 tolerance (test_torch_zoo.py,
test_torch_decoder.py: 1.8e-2), against the JAX program compiled to
round as written; the gradient norms' gap is printed (run with ``-s``)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_lm import AS_WRITTEN, f32, rel, setup               # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401 (autouse)

ARCHS = ("stablelm_1_6b", "mixtral_8x7b", "mamba2_130m",
         "recurrentgemma_9b", "internvl2_26b", "whisper_base")
#: the forwards' bf16 tolerance, here relative to the loss
LOSS_RTOL = 1.8e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_first_step_loss(arch):
    m = setup(arch)
    _, mj = m.jax_step(**AS_WRITTEN)
    _, mt = m.port_step()
    loss_gap = rel(mt["loss"], mj["loss"])
    gnorm_gap = rel(mt["grad_norm"], mj["grad_norm"])
    print(f"{arch} bf16 first step: loss {float(mt['loss']):.6f} vs "
          f"{float(mj['loss']):.6f} (rel {loss_gap:.3e}), grad_norm "
          f"{float(mt['grad_norm']):.6f} vs {float(mj['grad_norm']):.6f} "
          f"(rel {gnorm_gap:.3e})")
    assert np.isfinite([float(mt["loss"]), float(mt["grad_norm"])]).all()
    assert loss_gap <= LOSS_RTOL
    assert f32(mt["lr"]) == f32(mj["lr"])
