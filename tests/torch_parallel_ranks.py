"""The rank side of the port's parallel tests (``tests/test_torch_parallel_*``,
``test_torch_multihost.py``, ``test_torch_cli_parallel.py``).

Each function here runs in a rank process started by
``dalle_pytorch_tpu_torch.parallel.launch.spawn`` on the CPU (gloo): it
takes numpy inputs and JAX parameter trees (numpy leaves) from the test,
runs the port, and sends numpy results home, where the test holds them
against the JAX package. Nothing here imports JAX, so a rank starts in
the time of a torch import. Every collective of a rank waits at most the
group's timeout on a peer; the spawn's deadline bounds the whole.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.tensor(np.asarray(a))


# -- collectives and the attention bodies -------------------------------------

def collectives_case(rank: int) -> dict:
    """Each differentiable collective's forward and its transpose on known
    inputs, and 16-bit floats and bools over gloo."""
    from dalle_pytorch_tpu_torch.parallel import collectives as col
    g = col.world()
    n, r = g.size, g.index
    out = {}
    x = torch.arange(6.0).reshape(2, 3).add(10 * r).requires_grad_()
    y = col.psum(x, g)
    (y * (r + 1)).sum().backward()
    out["psum"] = (_np(y), _np(x.grad))
    x = torch.full((2, 3), float(r)).requires_grad_()
    y = col.all_gather(x, g, dim=1)
    (y * torch.arange(y.numel()).reshape(y.shape) * (r + 1)).sum().backward()
    out["all_gather"] = (_np(y), _np(x.grad))
    x = (torch.arange(n * 2 * 3.0).reshape(n * 2, 3) + 100 * r
         ).requires_grad_()
    y = col.all_to_all(x, g, split_dim=0, concat_dim=1)
    (y * (r + 1)).sum().backward()
    out["all_to_all"] = (_np(y), _np(x.grad))
    x = torch.full((3,), float(r)).requires_grad_()
    y = col.ppermute(x, g, shift=1)
    (y * (r + 1)).sum().backward()
    out["ppermute"] = (_np(y), _np(x.grad))
    b = torch.tensor([1.5, -2.25, r], dtype=torch.bfloat16)
    out["bf16_gather"] = _np(col.all_gather(b, g).float())
    m = torch.tensor([True, r % 2 == 0])
    out["bool_permute"] = _np(col.ppermute(m, g))
    out["bf16_psum"] = _np(col.psum(b, g).float())
    return out


def attention_case(rank: int, spec: dict) -> dict:
    """Ring and Ulysses over the world as one ``sp`` axis (or ``dp`` x
    ``sp`` with ``spec['dp']``): global outputs, and the gradients of
    sum(y^2) through the local bodies, summed over the ranks."""
    from dalle_pytorch_tpu_torch.parallel import collectives as col
    from dalle_pytorch_tpu_torch.parallel import ring
    from dalle_pytorch_tpu_torch.parallel.mesh import make_mesh
    q, k, v = (_t(a) for a in spec["qkv"])
    mask = _t(spec["mask"])
    n = col.world().size
    dp = spec.get("dp", 1)
    mesh = make_mesh({"dp": dp, "sp": n // dp} if dp > 1 else {"sp": n})
    batch_axis = "dp" if dp > 1 else None
    out = {}
    for name, causal, masked, chunks in spec["cases"]:
        kw = dict(mesh=mesh, causal=causal, batch_axis=batch_axis,
                  mask=mask if masked else None)
        if name == "ring":
            y = ring.ring_attention(q, k, v, **kw)
        else:
            y = ring.ulysses_attention(q, k, v, kv_chunks=chunks, **kw)
        out[(name, causal, masked, chunks)] = _np(y)
    if spec.get("grads"):
        sp = mesh.group("sp")
        nl = q.shape[2] // sp.size
        sl = slice(sp.index * nl, (sp.index + 1) * nl)
        for name in ("ring", "ulysses"):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            body = (ring.ring_attention_local if name == "ring"
                    else ring.ulysses_attention_local)
            y = body(*(t[:, :, sl] for t in leaves), group=sp, causal=True,
                     mask=mask[:, sl])
            y.square().sum().backward()
            out[("grad", name)] = [_np(col.psum(t.grad, sp)) for t in leaves]
    return out


# -- the sequence-parallel stack ----------------------------------------------

def _tcfg(kw):
    from dalle_pytorch_tpu_torch.ops.transformer import TransformerConfig
    return TransformerConfig(**kw)


def sp_stack_case(rank: int, spec: dict) -> dict:
    """``sp_transformer_apply`` over sp = the world (or ``dp`` x ``sp``):
    outputs for each case, the gradients of sum(y^2) under each remat
    mode (this rank's positions, summed over sp)."""
    from dalle_pytorch_tpu_torch.compat import from_jax
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel import collectives as col
    from dalle_pytorch_tpu_torch.parallel.mesh import make_mesh
    from dalle_pytorch_tpu_torch.parallel.sequence import sp_transformer_apply
    import dataclasses
    n = col.world().size
    dp = spec.get("dp", 1)
    mesh = make_mesh({"dp": dp, "sp": n // dp} if dp > 1 else {"sp": n})
    cfg = _tcfg(spec["cfg"])
    model = from_jax.transformer_from_jax(spec["params"], cfg, device="cpu")
    x, mask = _t(spec["x"]), _t(spec["mask"])
    out = {}
    for impl, masked, train in spec["cases"]:
        with torch.no_grad():
            y = sp_transformer_apply(
                model, x, cfg=cfg, mesh=mesh, impl=impl,
                batch_axis="dp" if dp > 1 else None,
                mask=mask if masked else None,
                rng=prng.prng_key(spec["seed"]) if train else None,
                train=train)
        out[(impl, masked, train)] = _np(y)
    sp = mesh.group("sp")
    nl = x.shape[1] // sp.size
    sl = slice(sp.index * nl, (sp.index + 1) * nl)
    for impl, mode in spec.get("remat", ()):
        rcfg = dataclasses.replace(cfg, remat=mode, attn_dropout=0.0,
                                   ff_dropout=0.0)
        model.zero_grad(set_to_none=True)
        y = sp_transformer_apply(model, x[:, sl], cfg=rcfg, mesh=mesh,
                                 impl=impl, mask=mask[:, sl], local=True)
        y.square().sum().backward()
        out[("remat", impl, mode)] = {
            name: _np(col.psum(p.grad, sp))
            for name, p in model.named_parameters()}
    return out


# -- steps ---------------------------------------------------------------------

def _args(**kw):
    import types
    base = dict(lr=1e-3, lr_schedule="constant", warmup_steps=0,
                decay_steps=0, lr_end_ratio=0.1, n_epochs=1,
                clip_grad_norm=0.0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _dalle_cfg(kw):
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    kw = dict(kw)
    kw["vae"] = V.VAEConfig(**kw["vae"])
    return D.DALLEConfig(**kw)


def _params_of(model, mesh=None, opt=None, specs=None):
    """{name: numpy} of every parameter, a pipeline's gathered from its
    stages (every rank of the first pipeline gets them)."""
    from dalle_pytorch_tpu_torch.compat import to_jax
    from dalle_pytorch_tpu_torch.parallel.train import checkpoint_state
    if specs is None:
        return {n: _np(p) for n, p in model.named_parameters()}
    state = checkpoint_state(model, opt, None, mesh, specs)
    if state is None:
        return None
    twin = to_jax.module(state[0], model)
    return {n: _np(p) for n, p in twin.named_parameters()}


def step_case(rank: int, spec: dict) -> dict:
    """``steps`` steps of ``make_train_step`` on ``spec['axes']`` from the
    JAX tree: the DALLE (plain, ``sp`` or ``pp`` loss), the VAE or CLIP.
    Returns the losses, the parameters after, the stage's parameter count,
    each layer's fsdp owner (None: fetched from no one) and the step's
    collectives."""
    from dalle_pytorch_tpu_torch.cli.common import make_optimizer
    from dalle_pytorch_tpu_torch.compat import from_jax
    from dalle_pytorch_tpu_torch.models import clip as C
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel import collectives as col
    from dalle_pytorch_tpu_torch.parallel import train as TP
    from dalle_pytorch_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from dalle_pytorch_tpu_torch.parallel.pipeline import (pp_dalle_loss_fn,
                                                           pp_param_specs)
    from dalle_pytorch_tpu_torch.parallel.sequence import sp_dalle_loss_fn
    mesh = make_mesh(spec["axes"])
    kind = spec["kind"]
    specs = None
    if kind == "vae":
        cfg = V.VAEConfig(**spec["cfg"])
        model = from_jax.discrete_vae_from_jax(spec["params"], cfg,
                                               device="cpu")
        loss_fn = TP.vae_loss_fn(cfg, smooth_l1=True,
                                 temperature=spec.get("temperature"))
    elif kind == "clip":
        cfg = C.CLIPConfig(**spec["cfg"])
        model = from_jax.clip_from_jax(spec["params"], cfg, device="cpu")
        loss_fn = TP.clip_loss_fn(mesh)
    else:
        cfg = _dalle_cfg(spec["cfg"])
        model = from_jax.dalle_from_jax(spec["params"], cfg, device="cpu")
        place = spec.get("place", {})
        if kind == "sp":
            loss_fn = sp_dalle_loss_fn(mesh, impl=spec.get("impl", "ring"))
        elif kind == "pp":
            loss_fn = pp_dalle_loss_fn(
                mesh, num_microbatches=spec.get("microbatches"))
            specs = pp_param_specs(model, ep=place.get("ep"))
        if kind != "pp" and "ep" in place:
            specs = TP.dalle_moe_param_specs(model, place["ep"])
        elif kind != "pp" and place:
            specs = TP.dalle_param_specs(
                model, tp=place.get("tp"), fsdp=place.get("fsdp"),
                mesh=mesh if spec.get("fit") else None)
        if kind not in ("sp", "pp"):
            def loss_fn(model, batch, rng):
                return D.dalle_apply(model, batch["text"], batch["image"],
                                     mask=batch.get("mask"), rng=rng,
                                     train=True, return_loss=True)
    opt = make_optimizer(_args(**spec.get("opt", {})), model.parameters())
    TP.setup_sharded(model, opt, mesh, specs)
    step = TP.make_train_step(loss_fn, opt, mesh=mesh, param_specs=specs,
                              grad_accum=spec.get("grad_accum", 1))
    batch = {k: _t(v) for k, v in spec["batch"].items()}
    for k in ("text", "image"):
        if k in batch and batch[k].dtype != torch.float32:
            batch[k] = batch[k].long()
    batch = shard_batch(mesh, batch, "dp", local=False)
    col.reset_stats()
    losses = []
    for i in range(spec.get("steps", 1)):
        losses.append(float(step(model, batch, prng.prng_key(spec["seed"]
                                                              + i))))
    stack = model.transformer.layers if kind not in ("vae", "clip") else []
    owners = [getattr(layer, "fsdp", None) for layer in stack]
    return {"losses": losses, "params": _params_of(model, mesh, opt, specs),
            "stage_params": sum(p.numel() for p in model.parameters()
                                if not p.is_meta),
            "owners": [o if o is None else o.index for o in owners],
            "calls": dict(col.STATS["calls"]), "coords": dict(mesh.coords)}


def step_cases(rank: int, specs: list) -> list:
    """``step_case`` of each spec in turn, in one spawn."""
    return [step_case(rank, spec) for spec in specs]


# -- placement: tp, fsdp, ep ------------------------------------------------------

def place_case(rank: int, spec: dict) -> dict:
    """A one-process step of the JAX weights (dropout keys
    ``spec['seed']``), its checkpoint's payload bytes, then that
    checkpoint restored into a second model that ``setup_sharded``
    places under ``spec['place']`` on ``spec['axes']`` (the moments by
    parameter name), and ``checkpoint_state``'s gathered trees as payload
    bytes: whether they are the same bytes, and the rank's stored
    parameter count."""
    from dalle_pytorch_tpu_torch import checkpoint as ckpt
    from dalle_pytorch_tpu_torch.cli.common import make_optimizer
    from dalle_pytorch_tpu_torch.compat import from_jax
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel import train as TP
    from dalle_pytorch_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(spec["axes"])
    cfg = _dalle_cfg(spec["cfg"])
    one = from_jax.dalle_from_jax(spec["params"], cfg, device="cpu")
    opt = make_optimizer(_args(**spec.get("opt", {})), one.parameters())
    b = {k: _t(v) for k, v in spec["batch"].items()}
    loss = D.dalle_apply(one, b["text"].long(), b["image"].long(),
                         mask=b["mask"], rng=prng.prng_key(spec["seed"]),
                         train=True, return_loss=True)
    loss.backward()
    opt.step()
    path = ckpt.save(os.path.join(spec["dir"], f"one-{rank}"), one,
                     opt_state=opt)
    want = ckpt._payloads(one, opt, None)
    model = from_jax.dalle_from_jax(spec["params"], cfg, device="cpu")
    opt = make_optimizer(_args(**spec.get("opt", {})), model.parameters())
    ckpt.restore_train(path, model, opt)
    place = spec["place"]
    specs = (TP.dalle_moe_param_specs(model, place["ep"]) if "ep" in place
             else TP.dalle_param_specs(model, tp=place.get("tp"),
                                       fsdp=place.get("fsdp")))
    TP.setup_sharded(model, opt, mesh, specs)
    out = {"stored": sum(p.numel() for p in model.parameters()
                         if not p.is_meta),
           "moments": sum(t.numel() for st in opt.adam.state.values()
                          for k, t in st.items() if k != "step")}
    state = TP.checkpoint_state(model, opt, None, mesh, specs)
    if state is not None:
        got = ckpt._payloads(state[0], state[1], None)
        out["same_bytes"] = {f: got.get(f) == data for f, data in
                             want.items()}
        out["files"] = sorted(got)
    return out


def place_cases(rank: int, specs: list) -> list:
    return [place_case(rank, spec) for spec in specs]


def tp_branches_case(rank: int, spec: dict) -> dict:
    """One layer's feed-forward and attention branches in train mode over
    ``tp`` = the world (dropout keys ``spec['seed']``): their outputs,
    which the row-parallel sums make whole on every rank."""
    from dalle_pytorch_tpu_torch.compat import from_jax
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.ops import transformer as T
    from dalle_pytorch_tpu_torch.parallel import train as TP
    from dalle_pytorch_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh({"tp": 2})
    cfg = _tcfg(spec["cfg"])
    model = from_jax.transformer_from_jax(spec["params"], cfg, device="cpu")
    specs = TP.dalle_param_specs(model, tp="tp")
    TP.setup_sharded(model, _Nothing(), mesh, specs)
    x = _t(spec["x"])
    key = prng.prng_key(spec["seed"])
    keys = prng.split(key, 2)
    with torch.no_grad():
        ff = T.ff_branch(model.layers[0], x, cfg, keys[1], True)
        attn = T.attn_branch(model.layers[0], x, None, cfg, keys[0], True)
        y = T.transformer_apply(model, x, cfg=cfg, rng=key, train=True)
    return {"ff": _np(ff), "attn": _np(attn), "stack": _np(y),
            "w1_rows": model.layers[0].ff.w1.weight.shape[0]}


def tp_logits_case(rank: int, spec: dict):
    """``dalle_apply``'s masked logits (eval) of the JAX weights placed
    by ``spec['place']`` on ``spec['axes']``."""
    from dalle_pytorch_tpu_torch.compat import from_jax
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.parallel import train as TP
    from dalle_pytorch_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(spec["axes"])
    model = from_jax.dalle_from_jax(spec["params"], _dalle_cfg(spec["cfg"]),
                                    device="cpu")
    specs = TP.dalle_param_specs(model, tp=spec["place"]["tp"])
    TP.setup_sharded(model, _Nothing(), mesh, specs)
    b = spec["batch"]
    with torch.no_grad():
        return _np(D.dalle_apply(model, _t(b["text"]).long(),
                                 _t(b["image"]).long(), mask=_t(b["mask"])))


class _Nothing:
    """An optimizer with no state, for placement alone."""
    clip = 0.0

    class adam:
        state: dict = {}

    @staticmethod
    def retain(model):
        pass


def moe_ep_case(rank: int, spec: dict) -> dict:
    """``moe_apply`` over ``ep`` = the world on JAX's MoE weights: its
    output and aux, and the gradients of sum(out^2) + aux gathered."""
    from dalle_pytorch_tpu_torch.ops import moe as M
    from dalle_pytorch_tpu_torch.parallel import collectives as col
    from dalle_pytorch_tpu_torch.parallel import placement as PL
    from dalle_pytorch_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh({"ep": 2})
    cfg = M.MoEConfig(**spec["cfg"])
    layer = M.MoE(cfg, device="cpu")
    with torch.no_grad():
        layer.router.weight.copy_(_t(spec["params"]["router"]["w"]).T)
        for k in ("w1", "w2"):
            getattr(layer, k).copy_(_t(spec["params"][k]))
    specs = M.moe_param_specs("ep")
    for name, p in layer.named_parameters():
        p.data = PL.shard(p.data, name, specs[name], mesh)
    layer.ep = mesh.group("ep")
    x = _t(spec["x"]).requires_grad_()
    out, aux = M.moe_apply(layer, x, cfg=cfg)
    # every rank computes the same value: its share is 1 / ep
    ((out.square().sum() + aux) / 2).backward()
    grads = {name: _np(PL.gather(p.grad, name, specs[name], mesh, None))
             for name, p in layer.named_parameters()}
    grads["router.weight"] = _np(col.psum(layer.router.weight.grad,
                                          mesh.group("ep")))
    return {"out": _np(out), "aux": float(aux),
            "dx": _np(col.psum(x.grad, mesh.group("ep"))), "grads": grads,
            "experts": layer.w1.shape[0]}


def generate_case(rank: int, spec: dict) -> dict:
    """``generate_images`` of JAX's weights over ``dp`` = the world: the
    gathered image ids and images, and with a CLIP the scores."""
    from dalle_pytorch_tpu_torch.compat import from_jax
    from dalle_pytorch_tpu_torch.models import clip as C
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh({"dp": spec["dp"]})
    cfg = _dalle_cfg(spec["cfg"])
    model = from_jax.dalle_from_jax(spec["params"], cfg, device="cpu")
    vae = from_jax.vae_from_jax(spec["vae"], cfg.vae, device="cpu")
    out = {}
    for name, kw in spec["cases"]:
        text = _t(spec["text"]).long()
        clip = None
        if kw.get("clip"):
            clip = from_jax.clip_from_jax(spec["clip"],
                                          C.CLIPConfig(**spec["clip_cfg"]),
                                          device="cpu")
            images, scores = D.generate_images(
                model, vae, text, rng=prng.prng_key(spec["seed"]),
                clip=clip, mesh=mesh, **kw.get("opts", {}))
            out[name] = {"images": _np(images), "scores": _np(scores)}
        else:
            images, ids = D.generate_images(
                model, vae, text, rng=prng.prng_key(spec["seed"]),
                return_img_seq=True, mesh=mesh, **kw.get("opts", {}))
            out[name] = {"images": _np(images), "ids": _np(ids)}
    return out


# -- the pipeline ---------------------------------------------------------------

def pp_stack_case(rank: int, spec: dict) -> dict:
    """``pipeline_transformer`` on ``spec['axes']`` (global inputs):
    outputs (and aux) of each case, and the gradients of sum(y^2) of the
    first case (every stage's layers, gathered by name)."""
    from dalle_pytorch_tpu_torch.compat import from_jax
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel import collectives as col
    from dalle_pytorch_tpu_torch.parallel.mesh import make_mesh
    from dalle_pytorch_tpu_torch.parallel.pipeline import pipeline_transformer
    mesh = make_mesh(spec["axes"])
    cfg = _tcfg(spec["cfg"])
    model = from_jax.transformer_from_jax(spec["params"], cfg, device="cpu")
    x, mask = _t(spec["x"]), _t(spec["mask"])
    dp_axis = "dp" if mesh.size("dp") > 1 else None
    out = {}
    for m, masked, train in spec["cases"]:
        with torch.no_grad():
            y, aux = pipeline_transformer(
                model, x, cfg=cfg, mesh=mesh, num_microbatches=m,
                dp_axis=dp_axis, mask=mask if masked else None,
                rng=prng.prng_key(spec["seed"]) if train else None,
                train=train, with_aux=True)
        out[(m, masked, train)] = (_np(y), float(aux))
    if spec.get("grads"):
        m, masked, _ = spec["cases"][0]
        y = pipeline_transformer(model, x, cfg=cfg, mesh=mesh,
                                 num_microbatches=m, dp_axis=dp_axis,
                                 mask=mask if masked else None)
        # every rank holds y whole: its share of sum(y^2) is 1 / world
        (y.square().sum() / col.world().size).backward()
        pp = mesh.group("pp")
        per = cfg.depth // pp.size
        grads = {}
        for name, p in model.named_parameters():
            layer = int(name.split(".")[1])
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            g = col.psum(g, mesh.group("dp"))
            grads[name] = _np(col.broadcast(g, pp, layer // per))
        out["grads"] = grads
    return out


# -- joining ------------------------------------------------------------------

def join_case(rank: int, spec: dict) -> dict:
    """Leave the spawn's group and join again from the environment (JAX's
    variables, then torchrun's), then the primary, ``fetch_local`` and a
    checkpoint written once."""
    import json
    from dalle_pytorch_tpu_torch.cli.common import save_checkpoint
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.parallel import multihost
    from dalle_pytorch_tpu_torch.parallel.mesh import make_mesh
    out = {"flags": (multihost.process_index(), multihost.process_count(),
                     multihost.backend())}
    for name, env in (("jax", {"JAX_COORDINATOR_ADDRESS":
                               f"127.0.0.1:{spec['ports'][0]}",
                               "JAX_NUM_PROCESSES": "2",
                               "JAX_PROCESS_ID": str(rank)}),
                      ("torchrun", {"MASTER_ADDR": "127.0.0.1",
                                    "MASTER_PORT": str(spec["ports"][1]),
                                    "WORLD_SIZE": "2", "RANK": str(rank),
                                    "LOCAL_RANK": str(rank)})):
        multihost.shutdown()
        saved = {k: os.environ.pop(k, None) for k in env}
        os.environ.update(env)
        try:
            joined = multihost.initialize(device="cpu", timeout_s=60.0)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        out[name] = (joined, multihost.process_index(),
                     multihost.process_count(), multihost.backend())
    out["primary"] = multihost.is_primary()
    mesh = make_mesh({"dp": 2})
    rows = torch.arange(3.0) + 10 * rank
    out["fetch"] = multihost.fetch_local(rows[None], mesh.group("dp"))
    cfg = V.VAEConfig(image_size=16, num_tokens=8, codebook_dim=8,
                      num_layers=2, hidden_dim=4)
    vae = V.discrete_vae_init(cfg, seed=0, device="cpu")
    path = save_checkpoint(os.path.join(spec["dir"], "once"), vae, None,
                           None, mesh=mesh, step=1, config=cfg, kind="vae",
                           meta={"rank": rank})
    with open(os.path.join(path, "manifest.json")) as f:
        out["manifest_rank"] = json.load(f)["meta"]["rank"]
    out["listing"] = sorted(os.listdir(spec["dir"]))
    return out


# -- the CLIs -----------------------------------------------------------------

def cli_case(rank: int, spec: dict) -> int:
    """Leave the spawn's group and run a training CLI with the
    multi-process flags, as a user's rank would."""
    import importlib
    from dalle_pytorch_tpu_torch.parallel import multihost
    multihost.shutdown()
    main = importlib.import_module(
        f"dalle_pytorch_tpu_torch.cli.{spec['cli']}").main
    argv = [a.replace("{rank}", str(rank)) for a in spec["argv"]]
    main(argv + ["--num_processes", str(spec["world"]), "--process_id",
                 str(rank), "--coordinator",
                 f"127.0.0.1:{spec['port']}"], device="cpu")
    return rank


# -- the card ---------------------------------------------------------------------

def tiny_dalle_cfg(dtype: str = "float32", heads: int = 2):
    """The card tests' tiny DALLE (dim 32, depth 2, 2 heads of 16 or 4 of
    8, text 8, a 16 px VAE of 32 codes) with the flash kernels and
    dropout 0.1."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    vcfg = V.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                       num_layers=2, hidden_dim=8)
    return D.DALLEConfig(dim=32, depth=2, vae=vcfg, num_text_tokens=64,
                         text_seq_len=8, heads=heads, dim_head=32 // heads,
                         attn_impl="flash", attn_bwd_impl="pallas",
                         attn_dropout=0.1, ff_dropout=0.1)


def tiny_batch(device, b: int = 4) -> dict:
    rs = np.random.RandomState(3)
    mask = np.ones((b, 8), bool)
    mask[1, 5:] = False
    return {"text": torch.tensor(rs.randint(1, 64, (b, 8)), device=device),
            "mask": torch.tensor(mask, device=device),
            "image": torch.tensor(rs.randint(0, 32, (b, 16)), device=device)}


class GradCapture:
    """An optimizer for ``make_train_step`` that keeps the step's reduced
    gradients instead of applying them (gathered whole from the ranks'
    pieces under a placement that splits them: ``mesh``, ``specs``)."""
    clip = 0.0

    def __init__(self, model, mesh=None, specs=None):
        self.model, self.grads = model, {}
        self.mesh, self.specs = mesh, specs

    def step(self, lr_scale=1.0, grad_norm=None):
        from dalle_pytorch_tpu_torch.parallel import placement as PL
        self.grads = {}
        for n, p in self.model.named_parameters():
            if p.grad is None:
                continue
            g = p.grad
            if self.specs:
                g = PL.gather(g, n, PL.spec_of(self.specs, n), self.mesh,
                              None)
            self.grads[n] = _np(g.float())
        for p in self.model.parameters():
            p.grad = None


def tiny_dp_grads(axes, device, heads: int = 2, tp: bool = False) -> tuple:
    """(loss, {name: gradient}, (K1, K2a, K2b launches)) of one step of the
    tiny DALLE on ``axes`` (this rank's rows), seeded weights and key;
    ``tp`` places it by ``dalle_param_specs(tp='tp')``."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.ops import flash_attention as FA
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from dalle_pytorch_tpu_torch.parallel.train import (make_train_step,
                                                         setup_sharded)
    from dalle_pytorch_tpu_torch.parallel.train import dalle_param_specs
    mesh = make_mesh(axes)
    model = D.dalle_init(tiny_dalle_cfg(heads=heads), seed=0, device=device)
    specs = dalle_param_specs(model, tp="tp", mesh=mesh) if tp else None
    cap = GradCapture(model, mesh, specs)

    def loss_fn(model, batch, rng):
        return D.dalle_apply(model, batch["text"], batch["image"],
                             mask=batch["mask"], rng=rng, train=True,
                             return_loss=True)

    from dalle_pytorch_tpu_torch.cli.common import make_optimizer
    setup_sharded(model, make_optimizer(_args(), model.parameters()), mesh,
                  specs)
    step = make_train_step(loss_fn, cap, mesh=mesh, param_specs=specs)
    counters = (FA.flash_attention_fwd, FA.flash_attention_bwd_dq,
                FA.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    loss = float(step(model, shard_batch(mesh, tiny_batch(device), "dp",
                                         local=False),
                      prng.prng_key(5, device=device)))
    return loss, cap.grads, tuple(c.launches - b for c, b in
                                  zip(counters, before))


def card_dp_case(rank: int) -> tuple:
    """A dp rank of the card test: its step's loss, the reduced gradients
    and its own kernel launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return tiny_dp_grads({"dp": 2}, torch.device("cuda"))


def run_cases(rank: int, items: list) -> list:
    """Each ``(function name, spec)`` of ``items`` in turn on this rank,
    in one spawn (one group per case group of a test file)."""
    return [globals()[fn](rank, spec) for fn, spec in items]



def card_tp_case(rank: int) -> tuple:
    """A tp rank of the card test: its step's loss, the reduced gradients
    gathered whole and its own kernel launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return tiny_dp_grads({"tp": 2}, torch.device("cuda"), heads=4, tp=True)
