"""The port's serving mesh (``serve/mesh_engine.py``,
``parallel/serve_specs.py``) on the CPU, against the port's single
``Engine`` and the JAX package's ``Engine`` on the same weights.

The contracts of JAX's ``tests/test_mesh_engine.py`` (its
``TestWorkerCheckpointSpec`` cases live in ``test_torch_process_*.py``):
a ``MeshEngine`` over two devices emits tokens BYTE-IDENTICAL to the
single engine's, dense and paged, at K 1/4/8, with int8 KV at both
layouts, across a mid-stream join and a warm prefix hit; the kernel read
is refused typed; the stats and HBM surface (per-shard KV bytes half the
pool's, the mesh shape); the config-only KV model equals the live pool;
a process parent computes no local slice; the slice composition rule;
the specs split only dimensions that are not summed over; the server's
``mesh_devices``; and a crash of mesh slice 1 replayed byte-identically
on slice 0. Beside them: speculation, a head whose columns split, a
slot migrated from a mesh to one engine, an engine that keeps none of
its caller's tensors, and the bytes a decode step joins against their
reckoning, at two sequence lengths; each shard attends over its own
heads, so no piece of a K/V buffer is joined in a decode step (a spy on
the join, seven paths). A mesh over a card and the CPU (two distinct
devices) is held to the single engine on the card in
``test_torch_mesh_cuda.py``.

Tolerance: none for tokens, compared for equality in float32. Each
layer's attention output, mesh against single engine, within 5e-5 of
its largest magnitude: a product over half the heads may round in the
last bit where the whole one does not.

The devices are two (or four) entries of the CPU device: PyTorch has no
forced host device count, so ``serve_specs.visible_devices`` is
substituted where the server and the replica set list devices, as
JAX's conftest forces 8 host devices. The tiny config (total_len 24):
depth 2 and heads 2 divide the 2-device mesh, so the weights and the KV
store both split.
"""

import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.parallel import serve_specs as JSS
from dalle_pytorch_tpu.serve import RequestQueue as JQueue
from dalle_pytorch_tpu.serve import Request as JRequest
from dalle_pytorch_tpu.serve import SamplingParams as JSampling
from dalle_pytorch_tpu.serve.engine import Engine as JEngine
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.parallel import placement as PL
from dalle_pytorch_tpu_torch.parallel import serve_specs as SS
from dalle_pytorch_tpu_torch.resilience import faults
from dalle_pytorch_tpu_torch.resilience.retry import RetryPolicy
from dalle_pytorch_tpu_torch.serve import kv_pool as KV
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve.engine import Engine
from dalle_pytorch_tpu_torch.serve.mesh_engine import (MeshEngine,
                                                       MeshPagedAttnError,
                                                       hbm_report)
from dalle_pytorch_tpu_torch.serve.replica import ReplicaSet

VK = dict(image_size=16, num_tokens=32, codebook_dim=16, num_layers=2,
          hidden_dim=8)
DK = dict(dim=16, depth=2, num_text_tokens=50, text_seq_len=8, heads=2,
          dim_head=8)
JCFG = JD.DALLEConfig(vae=JV.VAEConfig(**VK), **DK)
TCFG = TD.DALLEConfig(vae=TV.VAEConfig(**VK), **DK)
CPU2 = [torch.device("cpu")] * 2

FAST = RetryPolicy(max_attempts=1, deadline_s=None, base_backoff_s=0.01,
                   backoff_multiplier=2.0, max_backoff_s=0.1, jitter=0.0)

REQS = [dict(codes=(3, 7, 9), seed=11),
        dict(codes=(5, 2, 8, 1, 4), seed=23, temperature=0.7,
             filter_thres=0.8),
        dict(codes=(6, 6), seed=5, temperature=1.3, top_p=0.9)]
P8 = (4, 1, 2, 3, 5, 6, 7, 2)
PREFIX_REQS = [dict(codes=P8, seed=31), dict(codes=P8, seed=37),
               dict(codes=P8, seed=41, cfg_scale=1.5)]


def req(mod_request, mod_sampling, r):
    return mod_request(codes=r["codes"], seed=r["seed"],
                       cfg_scale=r.get("cfg_scale", 0.0),
                       sampling=mod_sampling(
                           temperature=r.get("temperature", 1.0),
                           filter_thres=r.get("filter_thres", 0.5),
                           top_p=r.get("top_p", 0.0)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_leaked_plan():
    faults.deactivate()
    yield
    faults.deactivate()


@pytest.fixture(scope="module")
def bundle():
    key = jax.random.PRNGKey(0)
    vae_p = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1),
                                       JCFG.vae))
    dal_p = jax.device_get(JD.dalle_init(key, JCFG, vae_p))
    return dal_p, from_jax.dalle_from_jax(dal_p, TCFG, device="cpu")


def port_tokens(model, cls, *, K=8, reqs=REQS, **kw):
    queue = S.RequestQueue(max_depth=16)
    where = dict(devices=CPU2) if cls is MeshEngine else dict(device="cpu")
    engine = cls(model, queue, num_slots=2, chunk_steps=K, **where, **kw)
    handles = [queue.submit(req(S.Request, S.SamplingParams, r))
               for r in reqs]
    engine.run_until_idle()
    toks = []
    for h in handles:
        res = h.result(timeout=60)
        assert res.status == S.OK, (res.status, res.reason)
        toks.append([int(t) for t in res.tokens])
    return engine, toks


_JAX: dict = {}


def jax_tokens(params, *, reqs=REQS, **kw):
    """The JAX engine's tokens at K 8 (its tokens do not depend on K)."""
    key = (len(reqs), reqs[0]["codes"], tuple(sorted(kw.items())))
    if key not in _JAX:
        queue = JQueue(max_depth=16)
        engine = JEngine(params, JCFG, queue, num_slots=2, chunk_steps=8,
                         **kw)
        handles = [queue.submit(req(JRequest, JSampling, r)) for r in reqs]
        engine.run_until_idle()
        _JAX[key] = [[int(t) for t in np.asarray(h.result(timeout=60).tokens)]
                     for h in handles]
    return _JAX[key]


def check_identity(bundle, *, K=8, reqs=REQS, **kw):
    """The mesh's tokens equal the port's single engine's and JAX's."""
    dal_p, model = bundle
    _, single = port_tokens(model, Engine, K=K, reqs=reqs, **kw)
    mesh, toks = port_tokens(model, MeshEngine, K=K, reqs=reqs, **kw)
    assert toks == single
    assert toks == jax_tokens(dal_p, reqs=reqs, **kw)
    return mesh


class TestMeshByteIdentity:
    @pytest.mark.parametrize("K", [1, 4, 8])
    def test_dense_tokens_byte_identical(self, bundle, K):
        mesh = check_identity(bundle, K=K)
        assert mesh.params_sharded and mesh.kv_sharded

    @pytest.mark.parametrize("K", [1, 4, 8])
    def test_paged_tokens_byte_identical(self, bundle, K):
        mesh = check_identity(bundle, K=K, kv="paged", page_size=8)
        assert mesh.kv_sharded

    @pytest.mark.parametrize("kw", [dict(quantize_cache=True),
                                    dict(kv="paged", page_size=8,
                                         quantize_cache=True)],
                             ids=["dense", "paged"])
    def test_int8_kv_tokens_byte_identical(self, bundle, kw):
        mesh = check_identity(bundle, **kw)
        from dalle_pytorch_tpu_torch.ops import decode as DO
        assert set(mesh.pool.parts[0]) == {"k", "v", "k_scale", "v_scale"}
        assert all(b.shape[2] == 1 for part, _, _ in DO.pool_shards(mesh.pool)
                   for b in part.values())

    def test_mid_stream_join(self, bundle):
        """A request joins while another slot is mid-decode; both keep
        the single engine's tokens."""
        dal_p, model = bundle
        kw = dict(kv="paged", page_size=8)
        _, ref = port_tokens(model, Engine, **kw)
        queue = S.RequestQueue(max_depth=16)
        engine = MeshEngine(model, queue, num_slots=2, chunk_steps=8,
                            devices=CPU2, **kw)
        h0 = queue.submit(req(S.Request, S.SamplingParams, REQS[0]))
        engine.step_once()
        engine.step_once()
        assert engine.active_slots() == 1
        h2 = queue.submit(req(S.Request, S.SamplingParams, REQS[2]))
        for _ in range(4):
            engine.step_once()
        engine.run_until_idle()
        got = [[int(t) for t in h.result(timeout=60).tokens]
               for h in (h0, h2)]
        assert got == [ref[0], ref[2]]
        assert got == [jax_tokens(dal_p, **kw)[i] for i in (0, 2)]

    def test_prefix_cache_warm_hit_byte_identical(self, bundle):
        """A warm hit on the head-split pool (shared pages, the boundary
        page's copy-on-write fork through every shard, the cached last
        row) with a guided pair riding along: the prefix-blind single
        engine's tokens."""
        dal_p, model = bundle
        kw = dict(reqs=PREFIX_REQS, kv="paged", page_size=8)
        _, blind = port_tokens(model, Engine, **kw)
        mesh, toks = port_tokens(model, MeshEngine, prefix_cache=True, **kw)
        assert mesh.prefix_hits >= 1 and mesh.cfg_pairs == 1
        assert toks == blind == jax_tokens(dal_p, **kw)

    def test_speculative_paged_tokens_byte_identical(self, bundle):
        """Speculation's draft (the first layers) and k-wide verify read
        the split pool shard by shard."""
        _, model = bundle
        kw = dict(kv="paged", page_size=8, speculative=2, draft_layers=1)
        _, single = port_tokens(model, Engine, **kw)
        _, toks = port_tokens(model, MeshEngine, **kw)
        assert toks == single

    def test_split_head_columns_byte_identical(self):
        """A vocabulary the mesh size divides (51 text tokens: 84 in
        all) splits the head's output columns; each shard computes its
        columns' logits, joined along the vocabulary before sampling."""
        cfg = TD.DALLEConfig(vae=TV.VAEConfig(**VK),
                             **{**DK, "num_text_tokens": 51})
        model = TD.DALLE(cfg, device="cpu")
        g = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
        mesh = MeshEngine(model, S.RequestQueue(max_depth=4),
                          devices=CPU2)
        assert mesh.param_specs["logits_proj.weight"] == PL.Spec(
            dims=("mp",))
        assert mesh.held[0]["logits_proj.weight"].shape == (42, 16)
        _, single = port_tokens(model, Engine)
        _, toks = port_tokens(model, MeshEngine)
        assert toks == single

    @pytest.mark.parametrize("case", ["sparse_reads", "reversible", "moe",
                                      "int8_weights"])
    def test_other_stacks_byte_identical(self, case):
        """The mesh binds whatever a layer holds: the sparse reads' trimmed
        views shard by shard, a reversible stack, MoE layers, and int8
        weights (buffers; with 84 tokens the head's ``w_q`` and ``scale``
        columns split)."""
        kw, engine_kw = {}, {}
        if case == "sparse_reads":
            kw = dict(sparse_attn=(False, True), sparse_block=8)
            engine_kw = dict(kv="paged", page_size=8, sparse_reads=True)
        elif case == "reversible":
            kw = dict(reversible=True)
        elif case == "moe":
            kw = dict(moe_experts=2, moe_k=1)
        else:
            kw = dict(num_text_tokens=51)
        cfg = TD.DALLEConfig(vae=TV.VAEConfig(**VK), **{**DK, **kw})
        model = TD.DALLE(cfg, device="cpu")
        g = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
        if case == "int8_weights":
            model = TD.quantize_for_decode(model)
        _, single = port_tokens(model, Engine, **engine_kw)
        mesh, toks = port_tokens(model, MeshEngine, **engine_kw)
        assert toks == single
        assert mesh.params_sharded and mesh.kv_sharded

    def test_slot_migrates_from_a_mesh_to_one_engine(self, bundle):
        """``export_slot`` joins the split pages whole and
        ``import_slot`` on a single engine continues the stream."""
        _, model = bundle
        kw = dict(num_slots=2, chunk_steps=4, kv="paged", page_size=8)
        _, ref = port_tokens(model, Engine, K=4, kv="paged", page_size=8)
        src = MeshEngine(model, S.RequestQueue(max_depth=4), devices=CPU2,
                         **kw)
        dst = Engine(model, S.RequestQueue(max_depth=4), device="cpu", **kw)
        h = src.queue.submit(req(S.Request, S.SamplingParams, REQS[1]))
        rid = h.request.request_id
        for _ in range(100):
            src.step_once()
            if src.progress_snapshot().get(rid, 0) >= 4:
                break
        assert not h.done()
        payload, handle = src.export_request(rid)
        dst.import_slot(payload, handle)
        dst.run_until_idle()
        assert [int(t) for t in h.result(timeout=30).tokens] == ref[1]


class TestMeshSurfaceAndSpecs:
    def test_kernel_attn_gated_typed(self, bundle):
        _, model = bundle
        with pytest.raises(MeshPagedAttnError) as ei:
            MeshEngine(model, S.RequestQueue(max_depth=4), devices=CPU2,
                       kv="paged", page_size=8, paged_attn="kernel")
        assert ei.value.record["kind"] == "serve_mesh_paged_attn_unsupported"
        with pytest.raises(MeshPagedAttnError):
            ReplicaSet(model, S.RequestQueue(max_depth=4), replicas=2,
                       devices_per_replica=2, kv="paged", page_size=8,
                       paged_attn="kernel", device="cpu")

    def test_stats_and_hbm_surface(self, bundle):
        _, model = bundle
        engine = MeshEngine(model, S.RequestQueue(max_depth=4),
                            num_slots=2, devices=CPU2, kv="paged",
                            page_size=8)
        st = engine.stats()
        assert st["mesh_shape"] == {"mp": 2}
        assert st["devices_per_replica"] == 2
        assert st["kv_hbm_bytes_per_shard"] * 2 == st["kv_hbm_bytes"]
        # 7 pages (2 slots x 3 + the trash page) x 8 rows x 1 head of 8,
        # K and V, 2 layers, float32: one shard's reckoning from shapes
        assert st["kv_hbm_bytes_per_shard"] == 7 * 8 * 1 * 8 * 2 * 2 * 4
        rep = hbm_report(engine)
        assert rep["kv_hbm_bytes_per_shard"] * 2 == rep["kv_hbm_bytes"]
        assert rep["param_bytes"] / 2 < rep["param_bytes_per_shard"] \
            < rep["param_bytes"]
        # each layer lives on its owner only
        assert any(n.startswith("transformer.layers.0.")
                   for n in engine.held[0])
        assert not any(n.startswith("transformer.layers.1.")
                       for n in engine.held[0])
        assert any(n.startswith("transformer.layers.1.")
                   for n in engine.held[1])
        st1 = Engine(model, S.RequestQueue(max_depth=4), num_slots=2,
                     device="cpu").stats()
        assert st1["devices_per_replica"] == 1
        assert st1["mesh_shape"] is None
        assert st1["kv_hbm_bytes_per_shard"] == st1["kv_hbm_bytes"]
        assert hbm_report(Engine(model, S.RequestQueue(max_depth=4),
                                 num_slots=2, device="cpu"))["devices"] == 1

    @pytest.mark.parametrize("kw", [
        dict(kv="dense"),
        dict(kv="paged", page_size=8),
        dict(kv="paged", page_size=8, quantize_cache=True)],
        ids=["dense", "paged", "int8"])
    def test_modeled_kv_bytes_matches_live_pool(self, bundle, kw):
        _, model = bundle
        modeled = KV.modeled_kv_bytes(
            TCFG.transformer, kv=kw["kv"], num_slots=2,
            total_len=TCFG.seq_len, page_size=kw.get("page_size", 0),
            quantized=kw.get("quantize_cache", False), dtype_bytes=4)
        engine = Engine(model, S.RequestQueue(max_depth=4), num_slots=2,
                        device="cpu", **kw)
        assert modeled == engine.kv_hbm_bytes()
        mesh = MeshEngine(model, S.RequestQueue(max_depth=4), num_slots=2,
                          devices=CPU2, **kw)
        assert mesh.kv_hbm_bytes() == modeled
        assert mesh.kv_bytes_per_shard() * 2 == modeled

    def test_remote_attach_mesh_needs_no_local_devices(self, bundle,
                                                       monkeypatch):
        """A process parent that sees no device at all builds a mesh set
        of socket workers: it computes no local slice."""
        _, model = bundle
        monkeypatch.setattr(SS, "visible_devices", lambda: [])
        rs = ReplicaSet(model, S.RequestQueue(max_depth=4), replicas=2,
                        isolation="process", transport="socket",
                        worker_cmd="", devices_per_replica=16,
                        device="cpu")
        try:
            assert all(not isinstance(r.device, tuple)
                       for r in rs.replicas)
            assert rs.stats()["devices_per_replica"] == 16
        finally:
            rs.close(timeout=2.0)

    def test_slice_devices_composition_rule(self):
        devs = list(range(8))
        for mod in (SS, JSS):
            assert mod.slice_devices(devs, 0, 2) == (0, 1)
            assert mod.slice_devices(devs, 3, 2) == (6, 7)
            assert mod.slice_devices(devs, 4, 2) == (0, 1)      # wraps
            assert mod.slice_devices(devs, 5, 1) == (5,)        # i % n
            with pytest.raises(ValueError):
                mod.slice_devices(devs[:1], 0, 2)
            with pytest.raises(ValueError):
                mod.slice_devices(devs, 0, 0)

    def test_param_specs_shard_only_uncontracted_dims(self, bundle):
        """The port's specs name its parameters as JAX's name its tree:
        depth for the layers, rows for the tables, nothing for the odd
        head (83 tokens) or the position tables."""
        dal_p, model = bundle
        mesh = SS.serve_mesh(CPU2)
        specs = SS.serve_param_specs(model, mesh)
        depth = PL.Spec(layers="mp")
        rows = PL.Spec(dims=("mp",))
        assert specs["transformer.layers.0.attn.qkv.weight"] == depth
        assert specs["transformer.layers.1.attn.ln.weight"] == depth
        assert specs["logits_proj.weight"] == PL.REPLICATED
        assert specs["text_emb.weight"] == rows
        assert specs["image_emb.weight"] == rows
        assert specs["text_pos_emb.weight"] == PL.REPLICATED
        # no spec splits a dimension past the first: a linear's input
        # columns, the one its product sums over, always stay whole
        assert not any(any(s.dims[1:]) for s in specs.values())
        # JAX's specs on the same weights say the same
        from jax.sharding import PartitionSpec as P
        jspecs = JSS.serve_param_specs(dal_p, JCFG,
                                       JSS.serve_mesh(jax.devices()[:2]))
        assert jspecs["transformer"]["attn"]["qkv"]["w"].spec == P("mp")
        assert jspecs["to_logits"]["proj"]["w"].spec == P()
        assert jspecs["text_emb"]["w"].spec == P("mp")
        assert jspecs["image_emb"]["w"].spec == P("mp")
        assert jspecs["text_pos_emb"]["w"].spec == P()
        kv = SS.serve_kv_specs({"k": torch.zeros(2, 3, 2, 8, 8)}, mesh)
        assert kv["k"] == PL.Spec(dims=(None, None, "mp"))
        assert SS.kv_is_sharded(kv)
        kv = SS.serve_kv_specs({"k": torch.zeros(2, 3, 3, 8, 8)}, mesh)
        assert kv["k"] == PL.REPLICATED and not SS.kv_is_sharded(kv)
        assert SS.kv_heads_shard(3, 2) is False
        assert SS.mesh_shape_desc(mesh) == {"mp": 2}
        assert SS.mesh_device_ids(mesh) == ["cpu", "cpu"]


class TestMeshServer:
    def test_server_serves_mesh_engine_with_mesh_health(self, bundle,
                                                        monkeypatch):
        from dalle_pytorch_tpu_torch.serve.server import InferenceServer
        dal_p, model = bundle
        monkeypatch.setattr(SS, "visible_devices", lambda: CPU2)
        srv = InferenceServer(model, None, num_slots=2, chunk_steps=8,
                              mesh_devices=2, decode_images=False,
                              device="cpu").start()
        try:
            assert isinstance(srv.engine, MeshEngine)
            res = srv.generate(REQS[0]["codes"], seed=REQS[0]["seed"],
                               timeout=120)
            assert res.status == S.OK
            assert [int(t) for t in res.tokens] == jax_tokens(dal_p)[0]
            health = srv.health()
            assert health["ok"]
            assert health["devices_per_replica"] == 2
            assert health["mesh_shape"] == {"mp": 2}
            st = srv.stats()
            assert st["mesh_shape"] == {"mp": 2}
            assert st["kv_hbm_bytes_per_shard"] * 2 == st["kv_hbm_bytes"]
        finally:
            srv.close()


class TestMeshReplicaSet:
    def test_mesh_slice_failover_replay_byte_identical(self, bundle,
                                                       monkeypatch):
        """Two mesh slices over four devices; slice 1 crashes mid-decode
        and its requests replay on slice 0 with the same tokens."""
        dal_p, model = bundle
        monkeypatch.setattr(SS, "visible_devices",
                            lambda: [torch.device("cpu")] * 4)
        calls = []
        slicer = SS.slice_devices
        monkeypatch.setattr(SS, "slice_devices", lambda d, i, m: (
            calls.append((len(d), i, m)) or slicer(d, i, m)))
        queue = S.RequestQueue(max_depth=16)
        rs = ReplicaSet(model, queue, replicas=2, num_slots=2,
                        chunk_steps=4, devices_per_replica=2,
                        bringup_policy=FAST, device="cpu")
        assert calls == [(4, 0, 2), (4, 1, 2)]
        assert all(isinstance(r.engine, MeshEngine) and r.engine.kv_sharded
                   for r in rs.replicas)
        handles = [queue.submit(req(S.Request, S.SamplingParams, r))
                   for r in REQS]
        with faults.injected(fault_replica=1, replica_crash_at_chunk=2):
            rs.run_until_idle()
        assert rs.failovers == 1
        assert rs.reclaimed >= 1, "the kill must have stranded work"
        want = jax_tokens(dal_p)
        for h, w in zip(handles, want):
            res = h.result(timeout=10)
            assert res.status == S.OK, (res.status, res.reason)
            assert [int(t) for t in res.tokens] == w
        stats = rs.stats()
        assert stats["completed"] == len(REQS)
        assert stats["devices_per_replica"] == 2
        assert stats["mesh_shape"] == {"mp": 2}
        assert stats["kv_hbm_bytes_per_shard"] * 2 == \
            rs.replicas[0].engine.kv_hbm_bytes()
        assert stats["tokens_decoded"] == sum(
            TCFG.seq_len - len(r["codes"]) for r in REQS)


def reachable_tensors(root) -> list:
    """Every tensor reachable from ``root`` through modules and the
    containers in their attributes."""
    seen, out, todo = set(), [], [root]
    while todo:
        x = todo.pop()
        if id(x) in seen:
            continue
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, torch.nn.Module):
            todo.extend(vars(x).values())
        elif isinstance(x, dict):
            todo.extend(x.values())
        elif isinstance(x, (list, tuple)):
            todo.extend(x)
    return out


class TestMeshHoldsOnlyItsShards:
    @pytest.mark.parametrize("weights", ["float32", "int8"])
    def test_engine_keeps_no_reference_to_the_callers_model(self, bundle,
                                                            weights):
        """Once the caller drops its model, every tensor object of it is
        gone, every weight the engine computes with is one of ``held``'s
        tensors, and the tokens are the single engine's."""
        dal_p, ref_model = bundle
        model = from_jax.dalle_from_jax(dal_p, TCFG, device="cpu")
        if weights == "int8":
            model = TD.quantize_for_decode(model)
            ref_model = TD.quantize_for_decode(ref_model)
        kw = dict(kv="paged", page_size=8)
        _, single = port_tokens(ref_model, Engine, **kw)
        refs = [weakref.ref(t) for t in SS.model_tensors(model).values()]
        queue = S.RequestQueue(max_depth=16)
        engine = MeshEngine(model, queue, num_slots=2, chunk_steps=8,
                            devices=CPU2, **kw)
        del model
        gc.collect()
        assert all(r() is None for r in refs)
        held = {id(t) for shard in engine.held for t in shard.values()}
        weights_seen = reachable_tensors(engine.model)
        assert weights_seen and all(id(t) in held for t in weights_seen)
        handles = [queue.submit(req(S.Request, S.SamplingParams, r))
                   for r in REQS]
        engine.run_until_idle()
        assert [[int(t) for t in h.result(timeout=60).tokens]
                for h in handles] == single

    @pytest.mark.parametrize("kw", [
        dict(kv="dense"),
        dict(kv="paged", page_size=8),
        dict(kv="paged", page_size=8, quantize_cache=True),
        dict(kv="paged", page_size=8, num_text_tokens=51)],
        ids=["dense", "paged", "int8", "split_head"])
    def test_join_bytes_per_step_match_the_reckoning(self, bundle, kw):
        """A chunk of decode steps with every slot admitted joins
        ``step_join_bytes`` a step: shard 1's layer, its head's
        attention output of both layers (one row a slot), its rows of
        the split tables looked up for each slot, and, where the head's
        columns split (84 tokens; the 83-column head stays whole), its
        columns of the logits. No cached K/V row is joined."""
        model = bundle[1]
        if "num_text_tokens" in kw:
            model = seeded_model(num_text_tokens=kw.pop("num_text_tokens"))
        engine, per_step = join_per_step(model, **kw)
        assert per_step == engine.step_join_bytes()
        tcfg, cfg = model.cfg.transformer, model.cfg
        layer1 = SS.tensor_bytes(t for n, t in engine.held[1].items()
                                 if PL.layer_of(n) == 1)
        # float32 activations, int8 KV or not
        attn = tcfg.depth * 2 * 1 * tcfg.dim_head * 4
        tables = sum(2 * cfg.dim * 4 for n in ("text_emb.weight",
                                               "image_emb.weight")
                     if n in engine.held[1])
        logits = 2 * (cfg.total_tokens // 2) * 4 \
            if "logits_proj.weight" in engine.held[1] else 0
        assert tables > 0 and (logits > 0) == (cfg.total_tokens == 84)
        assert per_step == layer1 + attn + tables + logits
        assert engine.step_join_terms() == dict(
            layers=layer1, attention=attn, logits=logits, rows=tables)

    def test_attention_term_does_not_grow_with_total_len(self):
        """Two sequence lengths (total_len 24 and 40): the attention
        outputs a step joins are the same bytes, reckoned and counted."""
        got = {}
        for text in (8, 24):
            cfg = TD.DALLEConfig(vae=TV.VAEConfig(**VK),
                                 **{**DK, "text_seq_len": text})
            model = TD.dalle_init(cfg, seed=1, device="cpu")
            engine, per_step = join_per_step(model, kv="paged", page_size=8)
            assert per_step == engine.step_join_bytes()
            got[engine.total_len] = engine.step_join_terms()
        assert sorted(got) == [24, 40]
        assert got[24]["attention"] == got[40]["attention"] \
            == DK["depth"] * 2 * 1 * DK["dim_head"] * 4
        assert got[24] == got[40]


def join_per_step(model, **kw):
    """A mesh over ``CPU2`` with both slots decoding: the bytes its join
    counted a decode step, over one chunk with no admission."""
    queue = S.RequestQueue(max_depth=16)
    engine = MeshEngine(model, queue, num_slots=2, chunk_steps=4,
                        devices=CPU2, **kw)
    for r in REQS[:2]:
        queue.submit(req(S.Request, S.SamplingParams, r))
    engine.step_once()
    assert engine.active_slots() == 2
    moved, steps = engine.stats()["join_bytes"], engine.decode_steps
    engine.step_once()
    return engine, ((engine.stats()["join_bytes"] - moved)
                    / (engine.decode_steps - steps))


def seeded_model(**kw):
    """A tiny DALLE with ``DK`` changed by ``kw`` and seeded weights."""
    cfg = TD.DALLEConfig(vae=TV.VAEConfig(**VK), **{**DK, **kw})
    model = TD.DALLE(cfg, device="cpu")
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    return model


def spy_joins(monkeypatch, engine):
    """Every piece the mesh's join gathers while a decode chunk runs,
    with the dim it was joined along."""
    seen, decoding = [], []
    sync = SS.replicate_sync

    def spying(mesh, dim):
        def run(pieces):
            if decoding:
                seen.extend((dim, p) for p in pieces)
            return sync(mesh, dim)(pieces)
        return run

    monkeypatch.setattr(SS, "replicate_sync", spying)
    chunk = engine._decode_chunk

    def decode_chunk():
        decoding.append(True)
        try:
            return chunk()
        finally:
            decoding.pop()

    engine._decode_chunk = decode_chunk
    return seen


class TestMeshAttendsPerShard:
    @pytest.mark.parametrize("case", [
        "dense", "paged", "int8", "sparse_reads", "speculative",
        "prefix_warm_hit", "mid_stream_join"])
    def test_no_kv_reaches_the_first_device_in_decode(self, bundle,
                                                      monkeypatch, case):
        """What the join gathers in a decode chunk is the shards'
        attention outputs (slots, 1 head, W <= k fresh rows, dh), their
        logits' columns and looked-up table rows, never a piece of a K/V
        buffer (no shared storage, no cached-row shape), and the tokens
        stay the single engine's."""
        _, model = bundle
        kw = dict(kv="paged", page_size=8)
        reqs, width = REQS, 1
        if case == "dense":
            kw = dict(kv="dense")
        elif case == "int8":
            kw["quantize_cache"] = True
        elif case == "sparse_reads":
            model = seeded_model(sparse_attn=(False, True), sparse_block=8)
            kw["sparse_reads"] = True
        elif case == "speculative":
            kw.update(speculative=2, draft_layers=1)
            width = 2
        elif case == "prefix_warm_hit":
            kw["prefix_cache"] = True
            reqs = PREFIX_REQS
        queue = S.RequestQueue(max_depth=16)
        engine = MeshEngine(model, queue, num_slots=2, chunk_steps=4,
                            devices=CPU2, **kw)
        seen = spy_joins(monkeypatch, engine)
        if case == "mid_stream_join":
            handles = [queue.submit(req(S.Request, S.SamplingParams,
                                        reqs[0]))]
            engine.step_once()
            engine.step_once()
            assert engine.active_slots() == 1
            handles.append(queue.submit(req(S.Request, S.SamplingParams,
                                            reqs[2])))
        else:
            handles = [queue.submit(req(S.Request, S.SamplingParams, r))
                       for r in reqs]
        engine.run_until_idle()
        got = [[int(t) for t in h.result(timeout=60).tokens]
               for h in handles]
        single = port_tokens(model, Engine, K=4, reqs=reqs,
                             **{k: v for k, v in kw.items()
                                if k != "prefix_cache"})[1]
        if case == "mid_stream_join":
            single = [single[0], single[2]]
        assert got == single
        if case == "prefix_warm_hit":
            assert engine.prefix_hits >= 1
        cfg = model.cfg
        buffers = {b.untyped_storage().data_ptr()
                   for part, _, _ in engine.pool.slices()
                   for b in part.values()}
        outputs = 0
        for dim, piece in seen:
            assert piece.untyped_storage().data_ptr() not in buffers
            if dim == 1:
                b, h, w, dh = piece.shape
                assert (b, h, dh) == (2, 1, cfg.dim_head) and w <= width, \
                    f"{case}: a joined piece of shape {tuple(piece.shape)}"
                outputs += 1
            else:
                assert piece.shape in ((2, cfg.dim),
                                       (2, cfg.total_tokens // 2)), \
                    f"{case}: a joined piece of shape {tuple(piece.shape)}"
        assert outputs > 0

    @pytest.mark.parametrize("kw", [
        dict(kv="dense"),
        dict(kv="paged", page_size=8),
        dict(kv="paged", page_size=8, quantize_cache=True)],
        ids=["dense", "paged", "int8"])
    def test_attention_outputs_per_layer_within_tolerance(self, bundle,
                                                          monkeypatch, kw):
        """Each layer's attention output of every decode step, mesh
        against single engine in float32: the largest absolute
        difference is at most 5e-5 times the output's largest
        magnitude (the shards' products over half the heads may round
        in the last bit)."""
        from dalle_pytorch_tpu_torch.ops import decode as DO
        _, model = bundle
        outs = []
        read = DO._read_layer

        def recording(*args, **kwargs):
            out = read(*args, **kwargs)
            outs[-1].append(out.clone())
            return out

        monkeypatch.setattr(DO, "_read_layer", recording)
        for cls in (Engine, MeshEngine):
            outs.append([])
            port_tokens(model, cls, K=4, **kw)
        single, mesh = outs
        assert len(single) == len(mesh) > 0
        for a, b in zip(single, mesh):
            assert a.shape == b.shape
            assert (a - b).abs().max() <= 5e-5 * a.abs().max()
