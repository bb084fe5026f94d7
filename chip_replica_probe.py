"""One run of the card test ``tests/test_torch_kernels_cuda.py::
test_tiny_replica_set_on_card_gives_the_cpu_tokens`` in this process,
with the replica set's own record of it: why and when a replica was
fenced, and where each engine's first seconds went.

    python3 chip_replica_probe.py            # one run, one JSON line
    for i in 1 2 3; do python3 chip_replica_probe.py; done

Each run is a fresh process (a cold card context, as a test process
has) and builds the set as the test does: the tiny DALLE in float32, a
threaded set of two replicas on the card, paged with the kernel read,
six requests. It waits for replica 0's first slot, drains replica 0,
and prints ``{"fenced_before_first_slot": bool, "fences": [{"replica",
"reason", "after_start_s"}], "start_s": seconds in ``start()`` (the
kernel's build or load), "engines": [{"replica", "stale_at_start_s":
seconds from construction to the first step, "first_admit_s",
"first_dispatch_s"}], "tokens_ok": bool}``.
"""

import copy
import json
import time

import torch

from dalle_pytorch_tpu_torch.models import dalle as D
from dalle_pytorch_tpu_torch.models import vae as V
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve.engine import Engine
from dalle_pytorch_tpu_torch.serve.replica import ReplicaSet


def timed_first(name: str, log: dict) -> None:
    """Record the seconds of each engine's first call of a method."""
    method = getattr(Engine, name)

    def run(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return method(self, *args, **kwargs)
        finally:
            log.setdefault(id(self), {}).setdefault(
                name, (t0, time.perf_counter() - t0))

    setattr(Engine, name, run)


def run_set(model, dev, log: dict) -> dict:
    q = S.RequestQueue(max_depth=16)
    rs = ReplicaSet(copy.deepcopy(model).to(dev), q, replicas=2,
                    num_slots=4, chunk_steps=2, kv="paged", page_size=8,
                    paged_attn="kernel", device=dev)
    engines = [r.engine for r in rs.replicas]
    built = [e.last_heartbeat for e in engines]
    t0, wall0 = time.perf_counter(), time.time()
    rs.start()
    start_s = time.perf_counter() - t0
    fenced_early = False
    try:
        handles = [q.submit(S.Request(codes=(3, 7, i + 1), seed=i))
                   for i in range(6)]
        deadline = time.perf_counter() + 60
        while True:
            eng = rs.replicas[0].engine
            if eng is None:
                fenced_early = True
                break
            if eng.active_slots() > 0:
                break
            if time.perf_counter() > deadline:
                raise TimeoutError("replica 0 took no slot in 60 s")
            time.sleep(0.001)
        if not fenced_early:
            rs.drain_replica(0)
        results = [h.result(timeout=120) for h in handles]
    finally:
        rs.close()
    fences = [{"replica": e["replica"], "reason": e["reason"],
               "after_start_s": e["time"] - wall0}
              for e in rs.flight.dump()
              if e.get("kind") == "serve_replica_fenced"]
    per = []
    for i, (e, b) in enumerate(zip(engines, built)):
        rec = log.get(id(e), {})
        step = rec.get("step_once")
        per.append({
            "replica": i,
            "stale_at_start_s": None if step is None else step[0] - b,
            "first_admit_s": rec.get("_admit", (None, None))[1],
            "first_dispatch_s": rec.get("_dispatch_chunk",
                                        (None, None))[1]})
    return {"fenced_before_first_slot": fenced_early, "fences": fences,
            "start_s": start_s, "engines": per,
            "tokens": [list(map(int, r.tokens)) for r in results],
            "all_ok": all(r.ok for r in results)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    vcfg = V.VAEConfig(image_size=32, num_tokens=32, codebook_dim=32,
                       num_layers=2, hidden_dim=8)
    cfg = D.DALLEConfig(dim=32, depth=2, vae=vcfg, num_text_tokens=64,
                        text_seq_len=8, heads=2, dim_head=16)
    model = D.dalle_init(cfg, seed=2, device="cpu")
    log: dict = {}
    for name in ("step_once", "_admit", "_dispatch_chunk"):
        timed_first(name, log)
    cpu = run_set(model, "cpu", log)
    card = run_set(model, torch.device("cuda"), log)
    out = {k: v for k, v in card.items() if k != "tokens"}
    out["tokens_ok"] = card["tokens"] == cpu["tokens"] and card["all_ok"]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
