"""The port's multi-process bring-up on the CPU (``parallel/multihost.py``,
``parallel/launch.py``), against the JAX package's contract
(``dalle_pytorch_tpu/parallel/multihost.py``, ``tests/test_multihost.py``).

A lone process with nothing set is no group (False), as JAX's; a join
with some fields missing names them; two ranks join from the flags, from
JAX's variables and from torchrun's, on gloo; ``is_primary`` is rank 0;
``fetch_local`` gathers the ranks' rows on every rank; a checkpoint
saved by every rank through ``cli/common.py::save_checkpoint`` is
written once, by rank 0, with no staging residue; a deadline-bound join
against a coordinator nobody runs ends in ``BringupError`` carrying
JAX's record (label, attempts, errors); an injected bring-up failure
(``faults.on_backend_init``) is retried and the join then succeeds; the
backend choice; and the launcher's deadline and failure reporting (a
rank that raises fails the call with its traceback, one that hangs is
killed at the deadline; a group whose join fails, its store's port
taken, starts again on a fresh port).
"""

import os
import socket
import time

import pytest

from dalle_pytorch_tpu_torch.parallel import launch, multihost

import torch_parallel_ranks as R

ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
       "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    yield
    multihost.shutdown()


def test_lone_process_is_no_group(clean_env):
    import jax
    assert multihost.initialize() is False
    assert multihost.process_count() == 1 and multihost.is_primary()
    # JAX's contract: the same call there is the same no-op
    from dalle_pytorch_tpu.parallel import multihost as JM
    assert jax.process_count() == 1 and JM.is_primary()


@pytest.mark.parametrize("kw, missing", [
    (dict(coordinator_address="127.0.0.1:1"), "process count"),
    (dict(num_processes=2), "coordinator address"),
    (dict(coordinator_address="127.0.0.1:1", num_processes=2),
     "process id")])
def test_partial_join_names_what_is_missing(clean_env, kw, missing):
    with pytest.raises(ValueError, match=missing):
        multihost.initialize(device="cpu", **kw)


def test_deadline_join_raises_bringup_error_with_the_record(clean_env):
    from dalle_pytorch_tpu_torch.resilience.retry import BringupError
    events = []
    t0 = time.monotonic()
    with pytest.raises(BringupError) as err:
        multihost.initialize(
            coordinator_address=f"127.0.0.1:{launch.free_port()}",
            num_processes=2, process_id=1, deadline_s=1.0, max_attempts=1,
            device="cpu", on_event=events.append)
    assert time.monotonic() - t0 < 30
    rec = err.value.record
    assert rec["label"] == "multihost_init" and rec["attempts"] == 1
    assert rec["kind"] == "bringup_failure" and rec["errors"]
    assert events and events[-1]["kind"] == "bringup_failure"
    assert multihost.backend() is None            # no group was recorded


def test_injected_bringup_failure_is_retried(clean_env):
    from dalle_pytorch_tpu_torch.resilience import faults
    events = []
    with faults.injected(backend_init_fail_attempts=1):
        assert multihost.initialize(
            coordinator_address=f"127.0.0.1:{launch.free_port()}",
            num_processes=1, process_id=0, deadline_s=30.0,
            max_attempts=2, device="cpu", on_event=events.append)
    assert [e["kind"] for e in events] == ["bringup_retry"]
    assert multihost.backend() == "gloo" and multihost.process_count() == 1
    # idempotent, as JAX's
    assert multihost.initialize()


def test_backend_choice():
    assert multihost.pick_backend("cpu", 2) == "gloo"
    # without a card every rank is gloo; with one card, two local ranks
    # cannot share it through NCCL
    import torch
    if not torch.cuda.is_available():
        assert multihost.pick_backend(None, 2, "127.0.0.1:1") == "gloo"


@pytest.fixture(scope="module")
def joined(tmp_path_factory):
    d = tmp_path_factory.mktemp("joined")
    spec = {"ports": [launch.free_port(), launch.free_port()],
            "dir": str(d)}
    return spawn_once(spec), d


def spawn_once(spec):
    return launch.spawn(R.join_case, 2, (spec,), device="cpu", timeout_s=180,
                        group_timeout_s=60)


@pytest.mark.parametrize("how", ["jax", "torchrun"])
def test_two_ranks_join_from_the_environment(joined, how):
    res, _ = joined
    for r, got in enumerate(res):
        assert got["flags"] == (r, 2, "gloo")
        assert got[how] == (True, r, 2, "gloo")


def test_primary_and_fetch_local(joined):
    res, _ = joined
    assert [got["primary"] for got in res] == [True, False]
    for got in res:
        assert got["fetch"].tolist() == [[0.0, 1.0, 2.0], [10.0, 11.0, 12.0]]


def test_checkpoint_written_once_without_residue(joined):
    res, d = joined
    for got in res:
        assert got["manifest_rank"] == 0          # rank 0's write
        assert got["listing"] == ["once"]
    assert sorted(os.listdir(d)) == ["once"]
    from dalle_pytorch_tpu import checkpoint as JC
    ok, why = JC.validate(str(d / "once"))
    assert ok, why


def _raises(rank):
    if rank == 1:
        raise RuntimeError("rank one fails on purpose")
    return rank


def _hangs(rank):
    time.sleep(600)


def test_launcher_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        launch.spawn(_raises, 2, device="cpu", timeout_s=120)


def test_launcher_puts_each_rank_on_its_card_by_default():
    """With no ``device`` a rank binds ``cuda:(local_rank % cards)``; with
    no card each rank fails as every entry point of the port does."""
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        launch.spawn(_raises, 2, timeout_s=120)


def test_launcher_joins_again_on_a_fresh_port(monkeypatch):
    """The port chosen for the group's store is taken before rank 0 binds
    it (another process may take it in between): that group cannot join,
    and the launcher starts it again on a fresh port."""
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen()
    ports = iter([taken.getsockname()[1]])
    real = launch.free_port
    monkeypatch.setattr(launch, "free_port", lambda: next(ports, None)
                        or real())
    try:
        assert launch.spawn(_raises, 1, device="cpu", timeout_s=120,
                            group_timeout_s=20) == [0]
        assert next(ports, None) is None        # the taken port was tried
    finally:
        taken.close()


def test_launcher_kills_ranks_past_the_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        launch.spawn(_hangs, 2, device="cpu", timeout_s=15)
    assert time.monotonic() - t0 < 60
