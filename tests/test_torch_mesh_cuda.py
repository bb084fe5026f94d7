"""The serving mesh (``serve/mesh_engine.py``) over two distinct devices,
``cuda:0`` and the CPU, against the single ``Engine`` on the card.

Shard 1 lies on the CPU: its layer is fetched to the card when it runs,
its heads attend on the CPU over its K/V there and only their attention
outputs are joined on the card, as are the rows it looks up in the
embedding tables, and every K/V write, prompt scatter and page copy
reaches it. These are the paths a mesh of several cards runs, and a
mesh over repeated entries of one device never does. Every test here
is marked ``cuda`` and skips where no CUDA device is visible. This file
imports no JAX, so it also runs where only the port's dependencies are
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py

Tolerance: none. Tokens are compared for equality, in float32 (TF32
off), at the tiny config of ``test_torch_mesh_engine.py``, and the bytes
a decode step joins equal their reckoning.
"""

import pytest
import torch

from dalle_pytorch_tpu_torch.models import dalle as D
from dalle_pytorch_tpu_torch.models import vae as V
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve.engine import Engine
from dalle_pytorch_tpu_torch.serve.mesh_engine import MeshEngine

CFG = D.DALLEConfig(vae=V.VAEConfig(image_size=16, num_tokens=32,
                                    codebook_dim=16, num_layers=2,
                                    hidden_dim=8),
                    dim=16, depth=2, num_text_tokens=50, text_seq_len=8,
                    heads=2, dim_head=8)
P8 = (4, 1, 2, 3, 5, 6, 7, 2)
# three requests, then three that share a prompt (a warm prefix hit on
# a paged pool with pages to spare for the cache) with one guided pair
REQS = [S.Request((3, 7, 9), seed=11),
        S.Request((5, 2, 8, 1, 4), seed=23, sampling=S.SamplingParams(
            temperature=0.7, filter_thres=0.8)),
        S.Request((6, 6), seed=5, sampling=S.SamplingParams(
            temperature=1.3, top_p=0.9)),
        S.Request(P8, seed=31), S.Request(P8, seed=37),
        S.Request(P8, seed=41, cfg_scale=1.5)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mesh spans a card and the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def tokens(model, **kw) -> tuple:
    queue = S.RequestQueue(max_depth=16)
    engine = (MeshEngine if "devices" in kw else Engine)(
        model, queue, num_slots=2, chunk_steps=4, **kw)
    handles = [queue.submit(r) for r in REQS]
    engine.run_until_idle()
    out = []
    for h in handles:
        res = h.result(timeout=60)
        assert res.status == S.OK, (res.status, res.reason)
        out.append([int(t) for t in res.tokens])
    return engine, out


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(kv="dense"),
    dict(kv="paged", page_size=8, num_pages=16, prefix_cache=True),
    dict(kv="paged", page_size=8, num_pages=16, prefix_cache=True,
         quantize_cache=True)],
    ids=["dense", "paged", "int8"])
def test_card_and_cpu_mesh_tokens_equal_the_single_engine(cuda, kw):
    model = D.dalle_init(CFG, seed=3, device=cuda)
    _, single = tokens(model, device=cuda, **kw)
    mesh, got = tokens(model, devices=[cuda, torch.device("cpu")], **kw)
    assert got == single
    assert mesh.kv_sharded and mesh.params_sharded
    assert mesh.pool.parts[1]["k"].is_cpu
    assert all(t.is_cpu for t in mesh.held[1].values())
    assert all(t.is_cuda for t in mesh.held[0].values())
    if kw["kv"] == "paged":
        assert mesh.prefix_hits >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(kv="dense"),
    dict(kv="paged", page_size=8, num_pages=16),
    dict(kv="paged", page_size=8, num_pages=16, quantize_cache=True)],
    ids=["dense", "paged", "int8"])
def test_card_and_cpu_mesh_joins_no_kv(cuda, kw):
    """A chunk of decode steps with both slots decoding joins onto the
    card ``step_join_bytes`` a step: shard 1's layer, its head's
    attention output (one row a slot a layer), its looked-up table rows;
    no byte of its K/V, which stays on the CPU."""
    model = D.dalle_init(CFG, seed=3, device=cuda)
    queue = S.RequestQueue(max_depth=16)
    mesh = MeshEngine(model, queue, num_slots=2, chunk_steps=4,
                      devices=[cuda, torch.device("cpu")], **kw)
    for r in REQS[:2]:
        queue.submit(r)
    mesh.step_once()
    assert mesh.active_slots() == 2
    moved, steps = mesh.stats()["join_bytes"], mesh.decode_steps
    mesh.step_once()
    torch.cuda.synchronize()
    per_step = ((mesh.stats()["join_bytes"] - moved)
                / (mesh.decode_steps - steps))
    tcfg = CFG.transformer
    assert all(b.is_cpu for b in mesh.pool.parts[1].values())
    assert per_step == mesh.step_join_bytes()
    assert mesh.step_join_terms()["attention"] == \
        tcfg.depth * 2 * 1 * tcfg.dim_head * 4
