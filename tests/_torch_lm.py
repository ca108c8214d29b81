"""Shared set-up of the LM training parity tests (test_torch_lm_train.py,
test_torch_lm_train_bf16.py): one smoke config's weights, drawn by the
port's ``init_params`` and carried into the JAX package as its pytree and
into the port by ``params_from_numpy``, a seeded batch (S + 1 tokens, a
vision prefix or encoder frames where the config takes them), and each
package's train step on them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as j_configs
from repro import optim as j_optim
from repro.launch import steps as j_steps
from repro_torch import configs
from repro_torch import optim
from repro_torch.launch import steps
from repro_torch.models import params_from_numpy
from repro_torch.models import transformer as T

#: the global batch, tokens a row (the model sees S, predicts S), and an
#: encoder-decoder's frames
B, S, ENC_LEN = 4, 16, 12
#: test_models.py::test_smoke_train_step's train config
TRAIN = dict(microbatches=2, warmup_steps=2, total_steps=10)
#: the JAX package compiled to round where its program is written to
AS_WRITTEN = {"xla_allow_excess_precision": False}


@dataclasses.dataclass
class Model:
    cfg_j: object
    cfg: object
    tree: dict               # the weights, numpy
    batch: dict              # numpy

    def state_j(self):
        pj = jax.tree.map(jnp.asarray, self.tree)
        return {"params": pj, "opt": j_optim.adamw_init(pj)}

    def state_t(self):
        pt = params_from_numpy(self.cfg, self.tree)
        return {"params": pt, "opt": optim.adamw_init(pt)}

    def batch_j(self, rows=slice(None)):
        return {k: jnp.asarray(v[rows]) for k, v in self.batch.items()}

    def batch_t(self, rows=slice(None)):
        return {k: torch.as_tensor(v[rows]) for k, v in self.batch.items()}

    def jax_step(self, **compiler):
        """(new state, metrics) of the JAX package's jitted train step."""
        fn = j_steps.make_train_step(self.cfg_j, j_steps.TrainConfig(**TRAIN))
        return jax.jit(fn, compiler_options=compiler or None)(
            self.state_j(), self.batch_j())

    def port_step(self):
        fn = steps.make_train_step(self.cfg, steps.TrainConfig(**TRAIN))
        return fn(self.state_t(), self.batch_t())


def setup(arch: str) -> Model:
    cfg_j = j_configs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    tree = T.tree_map(lambda a: a.numpy(), T.init_params(
        cfg, torch.Generator().manual_seed(0)))
    rng = np.random.RandomState(1)
    batch = {"tokens": rng.randint(0, cfg.vocab, (B, S + 1)).astype(np.int32)}
    if cfg.n_prefix:
        batch["prefix_embeds"] = rng.randn(
            B, cfg.n_prefix, cfg.d_model).astype(np.float32)
    if cfg.kind == "encdec":
        batch["enc_embeds"] = rng.randn(B, ENC_LEN, cfg.d_model).astype(
            np.float32)
    return Model(cfg_j, cfg, tree, batch)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def rel(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))
