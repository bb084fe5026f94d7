"""The JAX side shared by ``tests/test_torch_parallel_tp.py``,
``test_torch_parallel_fsdp.py`` and ``test_torch_parallel_ep.py``: the
small DALLE configurations, JAX's one-device training step over the
whole batch, and the port's ``placement.Spec`` trees laid out as JAX's
``PartitionSpec`` trees (depth-stacked, linear weights (in, out)).
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec as P

from dalle_pytorch_tpu.cli import common as JCOM
from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.parallel import train as JP

VAE = dict(image_size=16, num_tokens=32, codebook_dim=32, num_layers=2,
           hidden_dim=8)
# 63 + 32 + 1 = 96 tokens, which tp 2 splits; EVEN_VOCAB's head runs
# column-parallel, ODD_VOCAB's (64 + 32 + 1 = 97) falls back to whole
DALLE = dict(dim=32, depth=2, num_text_tokens=63, text_seq_len=8, heads=4,
             dim_head=8, attn_dropout=0.1, ff_dropout=0.1)
ODD_VOCAB = dict(DALLE, num_text_tokens=64)
MOE = dict(DALLE, moe_experts=4, moe_k=2)
B = 4
STEPS = 2
SEED = 7
CLIP_NORM = 1.0
# the parameters after two Adam steps (lr 1e-3, clip 1.0) against JAX's
# one-device step
PARAM_ATOL = 2e-5


def opt_args(clip: float = CLIP_NORM):
    return types.SimpleNamespace(lr=1e-3, lr_schedule="constant",
                                 warmup_steps=0, decay_steps=0,
                                 lr_end_ratio=0.1, n_epochs=1,
                                 clip_grad_norm=clip)


def jax_cfg(kw: dict):
    return JD.DALLEConfig(vae=JV.VAEConfig(**VAE), **kw)


def torch_cfg(kw: dict):
    from dalle_pytorch_tpu_torch.models import dalle as TD
    from dalle_pytorch_tpu_torch.models import vae as TV
    return TD.DALLEConfig(vae=TV.VAEConfig(**VAE), **kw)


def setup(kw: dict, b: int = B):
    """(JAX params as numpy, numpy batch) from seeds."""
    jcfg = jax_cfg(kw)
    key = jax.random.PRNGKey(0)
    vae = JV.vae_init(jax.random.fold_in(key, 1), jcfg.vae)
    params = jax.device_get(JD.dalle_init(key, jcfg, vae))
    rs = np.random.RandomState(3)
    mask = np.ones((b, 8), bool)
    mask[1, 5:] = False
    mask[b - 1, 2:] = False
    batch = {"text": rs.randint(1, kw["num_text_tokens"],
                                (b, 8)).astype(np.int32),
             "image": rs.randint(0, 32, (b, 16)).astype(np.int32),
             "mask": mask}
    return params, batch


def step_spec(kw: dict, axes: dict, place: dict, **extra) -> dict:
    """The rank side's ``step_case`` spec for config ``kw`` on ``axes``."""
    params, batch = setup(kw)
    return {"kind": extra.pop("kind", "dalle"), "axes": axes,
            "place": place, "cfg": {**kw, "vae": VAE}, "params": params,
            "batch": batch, "seed": SEED, "steps": STEPS,
            "opt": {"clip_grad_norm": CLIP_NORM}, **extra}


def jax_steps(kw: dict, steps: int = STEPS):
    """(losses, parameters by port name) of JAX's one-device
    ``make_train_step`` over the whole batch."""
    from dalle_pytorch_tpu_torch.compat import from_jax
    params, batch = setup(kw)
    jcfg = jax_cfg(kw)
    opt = JCOM.make_optimizer(opt_args())
    step = jax.jit(JP.make_train_step(JP.dalle_loss_fn(jcfg), opt))
    state, losses = opt.init(params), []
    for i in range(steps):
        params, state, loss = step(params, state,
                                   {k: jnp.asarray(v) for k, v in
                                    batch.items()},
                                   jax.random.PRNGKey(SEED + i))
        losses.append(float(loss))
    # jaxlint: disable=JL001 — terminal fetch for the comparison
    model = from_jax.dalle_from_jax(jax.device_get(params), torch_cfg(kw),
                                    device="cpu")
    return losses, {n: p.detach().numpy() for n, p in
                    model.named_parameters()}


def assert_step_matches(got: dict, want, loss_rtol: float = 1e-5):
    losses, params = want
    np.testing.assert_allclose(got["losses"], losses, rtol=loss_rtol)
    if got["params"] is None:           # a rank of a later dp row
        return
    assert set(got["params"]) == set(params)
    for name, p in got["params"].items():
        np.testing.assert_allclose(p, params[name], atol=PARAM_ATOL,
                                   err_msg=name)


# -- the port's specs in JAX's layout -----------------------------------------

def _pad(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def port_specs_as_jax(model, specs: dict) -> dict:
    """{JAX leaf path: spec tuple padded to the leaf's rank} of the port's
    ``specs``: a layer parameter's spec is (its depth axis, its dims), a
    linear weight's dims reversed to JAX's (in, out). The leaf of each
    name is found by laying its index out through ``to_jax``."""
    from dalle_pytorch_tpu_torch.compat import to_jax
    from dalle_pytorch_tpu_torch.ops import transformer as T
    named = list(model.named_parameters())
    index = {n: torch.full(p.shape, float(i), dtype=torch.float64)
             for i, (n, p) in enumerate(named)}
    ids = {id(p): n for n, p in named}
    if isinstance(model, T.Transformer):
        tree = to_jax._transformer(model, lambda p: index[ids[id(p)]])
        stacked_root = True
    else:
        tree = to_jax.tree(model, index)
        stacked_root = False
    out = {}
    leaves = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tree))[0]
    for path, leaf in leaves:
        keys = tuple(getattr(k, "key", getattr(k, "idx", None))
                     for k in path)
        stacked = stacked_root or "transformer" in keys
        per = [named[int(i)][0] for i in
               (leaf.reshape(leaf.shape[0], -1)[:, 0] if stacked
                else leaf.reshape(-1)[:1])]
        got = set()
        for name in per:
            spec = specs[name]
            mod = model.get_submodule(name.rsplit(".", 1)[0])
            dims = _pad(spec.dims, leaf.ndim - (1 if stacked else 0))
            if isinstance(mod, torch.nn.Linear) and name.endswith(".weight"):
                dims = dims[::-1]
            got.add(((spec.layers,) if stacked else ()) + dims)
        assert len(got) == 1, (keys, got)
        out[keys] = got.pop()
    return out


def jax_specs(params, specs) -> dict:
    """{JAX leaf path: spec tuple padded to the leaf's rank}."""
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    shapes = dict((tuple(getattr(k, "key", getattr(k, "idx", None))
                         for k in path), np.shape(leaf))
                  for path, leaf in
                  jax.tree_util.tree_flatten_with_path(params)[0])
    out = {}
    for path, spec in flat:
        keys = tuple(getattr(k, "key", getattr(k, "idx", None))
                     for k in path)
        out[keys] = _pad(spec, len(shapes[keys]))
    return out
