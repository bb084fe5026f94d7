"""Shared CLI plumbing: flags, run set-up, resume, the supervised loop,
per-step keys, the learning-rate schedule, the optimizer and the EMA.

Port of ``dalle_pytorch_tpu/cli/common.py``: ``say`` (``:27``),
``resolve_resume`` (``:36``), ``plan_resume`` (``:56``),
``make_supervisor`` (``:107``), ``restore_rollback`` (``:120``),
``add_common_args`` (``:144``, the same flags and defaults),
``step_rng`` (``:266``), ``resolve_schedule`` (``:277``),
``make_optimizer`` (``:307``), ``make_ema`` (``:343``), ``ema_as``
(``:410``), ``LoopState`` (``:416``), ``run_supervised_loop``
(``:441``), ``load_caption_dataset`` (``:554``) and ``setup_run``
(``:572``). A rank is one process on one device: ``setup_run`` joins the
processes named by ``--coordinator``/``--num_processes``/``--process_id``
(or the environment) and lays them out as JAX's mesh ``{dp, sp}``,
``{dp, pp}`` or ``{dp}`` with JAX's refusals; ``say``, the vocabulary
and ``save_checkpoint`` act on the primary rank only, the others waiting
at a barrier. ``--guard_transfers`` runs each step body under
``transfer_guard`` (JAX's ``guards.no_transfers``, ``:472-514``): on the
card every synchronizing call in the body raises at the call, and the
body's one deliberate host-to-card copy, the step counter of
``step_rng``, goes through ``ops.core.device_put`` (pinned and
asynchronous), as JAX spells its ``device_put``. The loss read stays outside the guard.

The optimizer is Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8
outside the square root; ``torch.optim.Adam`` computes the same update,
``lr * m_hat / (sqrt(v_hat) + eps)``), under optax's schedules evaluated
at the update count: update ``i`` (from 0) uses ``schedule(i)``, so a
warm-up from 0 makes the first update zero, as in optax. The optional
global-norm clip is ``torch.nn.utils.clip_grad_norm_``, which scales by
``max_norm / (norm + 1e-6)`` where optax's ``clip_by_global_norm``
scales by ``max_norm / norm``: a relative difference of ``1e-6 / norm``
whenever the clip acts. ``Optimizer.state_tree`` / ``load_state_tree``
map its state to and from optax's tree (``checkpoint.py`` writes it).
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import math
import os
import sys
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from dalle_pytorch_tpu_torch import checkpoint as ckpt
from dalle_pytorch_tpu_torch.ops import core, prng


def say(*parts, **kw) -> None:
    """print() on the primary rank only (every rank of a multi-process
    run would echo each line once)."""
    from dalle_pytorch_tpu_torch.parallel.multihost import is_primary
    if is_primary():
        print(*parts, **kw)


def resolve_resume(name_or_path: str, models_dir: str, start_epoch: int):
    """A --loadVAE/--load_dalle value -> (checkpoint path, start_epoch).
    A directory path is used as-is; a name with ``start_epoch > 0`` maps
    to ``{models_dir}/{name}-{start_epoch-1}``; a bare name with no
    start_epoch resumes from the newest checkpoint."""
    if os.path.isdir(name_or_path):
        return name_or_path, start_epoch
    if start_epoch > 0:
        return ckpt.ckpt_path(models_dir, name_or_path,
                              start_epoch - 1), start_epoch
    found = ckpt.latest(models_dir, name_or_path)
    if found is None:
        raise FileNotFoundError(
            f"no checkpoint named {name_or_path!r} under {models_dir!r} "
            "(give --start_epoch to pick a specific epoch)")
    path, epoch = found
    return path, epoch + 1


def plan_resume(args, name: str, explicit: str = "",
                steps_per_epoch: int = 0):
    """Where should this run continue from? None (fresh start) or
    ``{path, start_epoch, skip_batches, step_in_epoch, global_step, meta,
    mid_epoch}``. ``--auto_resume`` wins: the newest valid checkpoint,
    step or epoch, by training progress; the data stream continues
    mid-epoch with no step repeated or skipped (``skip_batches`` counts
    source records, bad ones included). Otherwise an ``explicit``
    --loadVAE/--load_dalle/--load_clip value resolves through
    ``resolve_resume``."""
    if args.auto_resume:
        from dalle_pytorch_tpu_torch.resilience.supervisor import \
            find_auto_resume
        found = find_auto_resume(args.models_dir, name)
        if found is not None:
            path, manifest = found
            meta = manifest.get("meta", {}) or {}
            if "step_in_epoch" in meta and "epoch" in meta:
                return {"path": path, "start_epoch": int(meta["epoch"]),
                        "skip_batches": int(meta.get(
                            "records_in_epoch", meta["step_in_epoch"])),
                        "step_in_epoch": int(meta["step_in_epoch"]),
                        "global_step": int(meta["global_step"]),
                        "meta": meta, "mid_epoch": True}
            epoch = int(meta.get("epoch", manifest.get("step", 0)))
            gs = meta.get("global_step")
            return {"path": path, "start_epoch": epoch + 1,
                    "skip_batches": 0, "step_in_epoch": 0,
                    "global_step": (int(gs) if gs is not None
                                    else (epoch + 1) * steps_per_epoch),
                    "meta": meta, "mid_epoch": False}
    if explicit:
        path, start_epoch = resolve_resume(explicit, args.models_dir,
                                           args.start_epoch)
        return {"path": path, "start_epoch": start_epoch,
                "skip_batches": 0, "step_in_epoch": 0,
                "global_step": start_epoch * steps_per_epoch,
                "meta": {}, "mid_epoch": False}
    return None


def make_supervisor(args, metrics, name: str, save_state):
    """The fault-tolerance supervisor of a training CLI, its signal
    handlers installed. ``save_state(path) -> path`` writes the CLI's
    whole training state."""
    from dalle_pytorch_tpu_torch.resilience.supervisor import \
        TrainSupervisor
    return TrainSupervisor(
        name=name, models_dir=args.models_dir, save_state=save_state,
        metrics=metrics, save_every=args.save_every,
        keep=args.keep_checkpoints, spike_factor=args.spike_factor,
        spike_window=args.spike_window, max_rollbacks=args.max_rollbacks,
        rewarm_steps=args.rewarm_steps).install_signal_handlers()


def restore_rollback(sup, model: torch.nn.Module, optimizer, ema,
                     mesh=None, param_specs=None):
    """Load the supervisor's newest valid anchor into ``model``,
    ``optimizer`` and (when the run keeps one) ``ema``, in place, after a
    NaN or loss-spike verdict, placed as the run was set up: a pipeline
    stage keeps only its layers (``param_specs``), and every replica the
    same values."""
    from dalle_pytorch_tpu_torch.parallel.train import setup_sharded
    path = sup.rollback_target()
    ckpt.restore_train(path, model, optimizer)
    if ema is not None:
        tree = ckpt.restore_ema(path)
        if tree is not None:
            _load_ema(ema, model, tree)
    if mesh is not None:
        optimizer.retain(model)
        setup_sharded(model, optimizer, mesh, param_specs)


def add_common_args(parser: argparse.ArgumentParser,
                    default_batch: int = 24) -> None:
    """The JAX CLIs' common flags, with their defaults."""
    a = parser.add_argument
    a("--batchSize", type=int, default=default_batch,
      help=f"global batch size (default: {default_batch})")
    a("--n_epochs", type=int, default=500,
      help="number of epochs (default: 500)")
    a("--lr", type=float, default=1e-4, help="learning rate (default: 1e-4)")
    a("--name", type=str, default=None, help="experiment name")
    a("--start_epoch", type=int, default=0,
      help="start epoch numbering when resuming")
    a("--models_dir", type=str, default="./models",
      help="checkpoint directory (default: ./models)")
    a("--results_dir", type=str, default="./results",
      help="sample/recon image directory")
    a("--log_interval", type=int, default=10)
    a("--seed", type=int, default=0)
    a("--dp", type=int, default=0,
      help="devices in the mesh (0 = every rank; one rank is one process "
           "on one device, so it must equal the world size)")
    a("--profile_dir", type=str, default="",
      help="write a torch.profiler trace here")
    a("--coordinator", type=str, default="",
      help="multi-process coordinator host:port (or JAX_COORDINATOR_"
           "ADDRESS / torchrun's MASTER_ADDR and MASTER_PORT)")
    a("--num_processes", type=int, default=0,
      help="multi-process process count (or JAX_NUM_PROCESSES / "
           "WORLD_SIZE)")
    a("--process_id", type=int, default=-1,
      help="this process's rank (or JAX_PROCESS_ID / RANK)")
    a("--nan_checks", action="store_true",
      help="torch.autograd anomaly detection (slow)")
    a("--metrics", type=str, default="", help="JSONL metrics file path")
    a("--lr_schedule", default="constant", choices=["constant", "cosine"],
      help="learning-rate schedule; 'cosine' decays from --lr to "
           "--lr*--lr_end_ratio over the requested run")
    a("--warmup_steps", type=int, default=0,
      help="linear LR warmup from 0 over this many steps")
    a("--decay_steps", type=int, default=0,
      help="cosine decay horizon in steps (0 = the full requested run: "
           "n_epochs x steps/epoch)")
    a("--lr_end_ratio", type=float, default=0.1,
      help="cosine floor as a fraction of --lr")
    a("--ema_decay", type=float, default=0.0,
      help="keep an exponential moving average of the params at this "
           "decay (e.g. 0.999; 0 = off), saved with each checkpoint; "
           "resuming a checkpoint that carries one needs the flag again "
           "(-1 discards it on purpose)")
    a("--clip_grad_norm", type=float, default=0.0,
      help="clip gradients to this global L2 norm before the update (0 = "
           "off); changes the optimizer state's shape: pass the same value "
           "when resuming")
    a("--auto_resume", action="store_true",
      help="resume from the newest VALID checkpoint (mid-epoch step "
           "checkpoints included); --n_epochs still counts the epochs to "
           "run from the resume point")
    a("--save_every", type=int, default=0,
      help="write a mid-epoch checkpoint every N steps (0 = per-epoch "
           "only)")
    a("--keep_checkpoints", type=int, default=3,
      help="retain this many step checkpoints")
    a("--spike_factor", type=float, default=0.0,
      help="roll back when the loss exceeds this multiple of the recent "
           "median (0 = NaN/Inf detection only)")
    a("--spike_window", type=int, default=16,
      help="running-median window for --spike_factor")
    a("--max_rollbacks", type=int, default=2,
      help="abort (TrainingDiverged) after this many rollbacks")
    a("--rewarm_steps", type=int, default=0,
      help="after a rollback, ramp the LR back up linearly over this many "
           "steps (0 = resume at full LR)")
    a("--max_bad_records", type=int, default=0,
      help="skip up to this many unreadable data records per epoch before "
           "failing the run")
    a("--init_deadline_s", type=float, default=0.0,
      help="deadline of each attempt to join the process group (0 = "
           "none); exhausted attempts exit with the failure record")
    a("--init_retries", type=int, default=3,
      help="bring-up attempts under --init_deadline_s")
    a("--guard_transfers", action="store_true",
      help="run every train-step body under torch.cuda."
           "set_sync_debug_mode('error'): an implicit device-to-host "
           "read or a copy from pageable host memory in the step raises "
           "at the call instead of stalling the card each step "
           "(deliberate copies go through pinned memory, asynchronously)")


@contextlib.contextmanager
def transfer_guard(device):
    """``--guard_transfers`` around one step body: on a CUDA ``device``,
    ``torch.cuda.set_sync_debug_mode("error")``, so every synchronizing
    CUDA call in the body (``.item()``, a device-to-host copy, a copy
    from pageable host memory, a stream sync) raises ``RuntimeError`` at
    the call; the previous mode is restored after, raise or not. On the
    CPU it does nothing."""
    if device is None or torch.device(device).type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def step_rng(key: torch.Tensor, step: int) -> torch.Tensor:
    """``fold_in(key, step)``: the key of training step ``step``, its
    counter shipped through ``core.device_put``."""
    return prng.fold_in(key, core.device_put(np.int64(step), key.device))


def resolve_schedule(args, steps_per_epoch: int = 0, start_epoch: int = 0,
                     resume_meta: Optional[dict] = None) -> dict:
    """The learning-rate schedule in effect, as a JSON-safe snapshot. The
    cosine horizon is, in order: an explicit ``decay_steps``, the one
    persisted in ``resume_meta['lr_schedule']``, or the whole run
    ``(start_epoch + n_epochs) * steps_per_epoch - warmup_steps``."""
    snap = (resume_meta or {}).get("lr_schedule") or {}
    decay = 0
    if args.lr_schedule == "cosine":
        decay = args.decay_steps or int(snap.get("decay_steps") or 0) \
            or max((start_epoch + args.n_epochs) * steps_per_epoch
                   - args.warmup_steps, 1)
        if snap.get("decay_steps") and args.decay_steps \
                and int(snap["decay_steps"]) != args.decay_steps:
            print(f"warning: --decay_steps {args.decay_steps} overrides "
                  f"the resumed run's horizon ({snap['decay_steps']} "
                  f"steps)", file=sys.stderr, flush=True)
    return {"schedule": args.lr_schedule, "lr": args.lr,
            "warmup_steps": args.warmup_steps, "decay_steps": decay,
            "lr_end_ratio": args.lr_end_ratio,
            "epochs_total": int(snap.get("epochs_total")
                                or (start_epoch + args.n_epochs))}


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over ``steps``, then end."""
    if steps <= 0:
        return lambda count: init
    return lambda count: init + (end - init) * min(max(count, 0), steps) \
        / steps


def _warmup_cosine(peak: float, warmup: int, decay_steps: int,
                   end: float) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps,
    end): linear warm-up, then cosine from peak to end over
    ``decay_steps - warmup`` updates."""
    warm = _linear(0.0, peak, warmup)
    horizon = decay_steps - warmup
    alpha = end / peak

    def cosine(count: int) -> float:
        count = min(count, horizon)
        c = 0.5 * (1.0 + math.cos(math.pi * count / horizon))
        return peak * ((1.0 - alpha) * c + alpha)

    return lambda count: warm(count) if count < warmup \
        else cosine(count - warmup)


class Optimizer:
    """Adam under a schedule, with an optional global-norm clip. ``step``
    applies the gradients the parameters hold, advances the schedule and
    clears the gradients. ``step(lr_scale=s)`` scales that one update by
    ``s``: for Adam, exactly optax's updates times ``s``, as JAX's
    ``make_train_step`` applies ``batch['lr_scale']``. ``scheduled``
    says whether optax would hold a schedule's state (a constant
    learning rate holds none)."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 schedule: Callable[[int], float], clip: float = 0.0,
                 scheduled: bool = True):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.clip = clip
        self.scheduled = scheduled
        self.count = 0
        self.adam = torch.optim.Adam(self.params, lr=schedule(0),
                                     betas=(0.9, 0.999), eps=1e-8)

    def _chain(self, adam: dict) -> dict:
        """optax's state around the adam stage, as ``to_bytes`` writes
        it: ``adam(sched)`` is chain(scale_by_adam, the learning-rate
        stage: EmptyState for a constant, ScaleByScheduleState(count)
        for a schedule); ``--clip_grad_norm`` chains clip_by_global_norm
        (EmptyState) in front."""
        lr_stage = {"count": adam["count"]} if self.scheduled else {}
        chain = {"0": adam, "1": lr_stage}
        return {"0": {}, "1": chain} if self.clip > 0 else chain

    def state_tree(self, model: torch.nn.Module, moments=None) -> dict:
        """optax's state for ``model``'s parameters (this optimizer's):
        ``mu`` and ``nu`` are torch's ``exp_avg`` and ``exp_avg_sq`` (zero
        before the first step) as JAX parameter trees, ``count`` the
        update count. ``moments`` ({name: exp_avg}, {name: exp_avg_sq})
        gives them instead (a pipeline's, gathered from its stages)."""
        from dalle_pytorch_tpu_torch.compat import to_jax

        def moment(key):
            return {n: self.adam.state[p][key] if key in self.adam.state.get(
                p, {}) else torch.zeros_like(p)
                for n, p in model.named_parameters()}

        mu, nu = moments if moments is not None else (
            moment("exp_avg"), moment("exp_avg_sq"))
        return self._chain({"count": np.asarray(self.count, np.int32),
                            "mu": to_jax.tree(model, mu),
                            "nu": to_jax.tree(model, nu)})

    def retain(self, model: torch.nn.Module) -> None:
        """Keep only ``model``'s parameters that hold values (not on the
        meta device): a pipeline stage's, after the others left."""
        keep = {id(p) for p in model.parameters() if not p.is_meta}
        for p in self.params:
            if id(p) not in keep:
                self.adam.state.pop(p, None)
        self.params = [p for p in model.parameters()
                       if id(p) in keep and p.requires_grad]
        self.adam.param_groups[0]["params"] = self.params

    def load_state_tree(self, model: torch.nn.Module, state: dict) -> None:
        """Take optax's state (``state_tree``'s layout, as a checkpoint
        restores it) for ``model``'s parameters; ``ValueError`` when its
        tree is another optimizer's."""
        from dalle_pytorch_tpu_torch.compat import msgpack, to_jax
        # the tree's layout only: a pipeline stage's other layers are on
        # the meta device and have no values to copy
        params = to_jax.tree(model, {
            n: torch.empty(p.shape, dtype=p.dtype) if p.is_meta else p
            for n, p in model.named_parameters()})
        state = msgpack.from_state_dict(
            self._chain({"count": 0, "mu": params, "nu": params}), state)
        if self.clip > 0:
            state = state["1"]
        adam = state["0"]
        count = int(np.asarray(adam["count"]))
        mu = to_jax.named(model, adam["mu"])
        nu = to_jax.named(model, adam["nu"])
        self.adam.state.clear()
        if count > 0:
            for n, p in model.named_parameters():
                if p.requires_grad and not p.is_meta:
                    self.adam.state[p] = {
                        "step": torch.tensor(float(count)),
                        "exp_avg": mu[n].to(p.device, p.dtype).clone(),
                        "exp_avg_sq": nu[n].to(p.device, p.dtype).clone()}
        self.count = count

    def step(self, lr_scale: float = 1.0,
             grad_norm: Optional[torch.Tensor] = None) -> None:
        """``grad_norm``: the global gradient norm where this optimizer's
        parameters are only part of the model (a pipeline stage); the
        clip scales by ``clip / (norm + 1e-6)`` at most 1, as
        ``clip_grad_norm_`` does."""
        if self.clip > 0 and grad_norm is not None:
            coef = torch.clamp(self.clip / (grad_norm + 1e-6), max=1.0)
            for p in self.params:
                if p.grad is not None:
                    p.grad.mul_(coef.to(p.grad.dtype))
        elif self.clip > 0:
            torch.nn.utils.clip_grad_norm_(self.params, self.clip)
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count) * lr_scale
        self.adam.step()
        self.adam.zero_grad(set_to_none=True)
        self.count += 1


def make_optimizer(args, params: Iterable[torch.nn.Parameter],
                   steps_per_epoch: int = 0, start_epoch: int = 0,
                   schedule: Optional[dict] = None) -> Optimizer:
    """Adam over ``params`` under the requested schedule, with
    ``args.clip_grad_norm`` > 0 adding the global-norm clip. ``schedule``
    is a ``resolve_schedule`` snapshot, resolved from the flags when
    None."""
    if schedule is None:
        schedule = resolve_schedule(args, steps_per_epoch, start_epoch)
    constant = args.lr_schedule == "constant" and not args.warmup_steps
    if constant:
        sched = lambda count: args.lr                       # noqa: E731
    elif args.lr_schedule == "constant":
        sched = _linear(0.0, args.lr, args.warmup_steps)
    else:
        sched = _warmup_cosine(
            args.lr, args.warmup_steps,
            args.warmup_steps + schedule["decay_steps"],
            args.lr * args.lr_end_ratio)
    return Optimizer(params, sched, getattr(args, "clip_grad_norm", 0.0),
                     scheduled=not constant)


def _load_ema(ema: dict, model: torch.nn.Module, tree) -> dict:
    """Copy a checkpoint's EMA tree into ``ema`` (float32, on ``model``'s
    devices) in place."""
    from dalle_pytorch_tpu_torch.compat import to_jax
    for name, t in to_jax.named(model, tree, dtype=torch.float32).items():
        ema[name] = t.to(ema[name].device)
    return ema


def make_ema(args, model: torch.nn.Module, resume_path: str = ""):
    """(ema, update) for ``args.ema_decay``, or (None, None) when it is
    <= 0. ``ema`` maps each parameter's name to a float32 copy whatever
    the parameter's dtype (at decay 0.999 a bfloat16 average cannot move:
    its ulp swallows the (1 - d) step); ``update(ema, model)`` sets each
    entry to ``d * e + (1 - d) * p.float()`` in place and returns
    ``ema``. With a ``resume_path`` the checkpoint's ``ema.msgpack``
    continues (a checkpoint without one starts from the parameters);
    resuming a checkpoint that has one with ``ema_decay`` 0 is refused
    (the average would be dropped), -1 discards it on purpose."""
    decay = getattr(args, "ema_decay", 0.0)
    if decay <= 0:
        if resume_path and os.path.exists(os.path.join(resume_path,
                                                       ckpt.EMA)):
            if decay < 0:
                say(f"warning: discarding the EMA in {resume_path!r} "
                    "(--ema_decay < 0)")
            else:
                raise SystemExit(
                    f"checkpoint {resume_path!r} carries an EMA but "
                    "--ema_decay was not given — resuming would silently "
                    "drop the accumulated average. Pass the original "
                    "--ema_decay to continue it, or --ema_decay -1 to "
                    "discard it on purpose.")
        return None, None
    d = float(decay)
    ema = {name: p.detach().float().clone()
           for name, p in model.named_parameters()}
    if resume_path:
        tree = ckpt.restore_ema(resume_path)
        if tree is not None:
            _load_ema(ema, model, tree)
        try:
            prev = ckpt.load_manifest(resume_path).get(
                "meta", {}).get("ema_decay")
        except Exception:
            prev = None
        if prev is not None and abs(prev - d) > 1e-12:
            say(f"warning: resume checkpoint was written with --ema_decay "
                f"{prev}; continuing with {d}")

    @torch.no_grad()
    def update(ema: dict, model: torch.nn.Module) -> dict:
        for name, p in model.named_parameters():
            ema[name].mul_(d).add_(p.float() * (1.0 - d))
        return ema

    return ema, update


def ema_as(ema: dict, model: torch.nn.Module) -> dict:
    """The float32 EMA cast to the dtypes of ``model``'s parameters: a
    state dict for eval or decode (``model.load_state_dict(...,
    strict=False)``)."""
    return {name: ema[name].to(p.dtype)
            for name, p in model.named_parameters()}


class LoopState:
    """The loop's position, shared by ``run_supervised_loop`` (which
    advances it) and the CLIs' ``save_state`` closures (which read it
    live for mid-epoch checkpoints)."""

    def __init__(self, epoch: int = 0, global_step: int = 0):
        self.epoch = epoch
        self.global_step = global_step
        self.epoch_i = 0          # TRAINED steps completed in this epoch
        self.train_loss = 0.0     # epoch-summary accumulators
        self.n_batches = 0
        self.rec_base = 0         # SOURCE records consumed before this
        self.pf = None            # epoch's prefetcher was built
        self.last = None          # payload of the last GOOD step

    @property
    def records_in_epoch(self) -> int:
        """SOURCE records consumed this epoch (bad skipped records
        included); differs from ``epoch_i`` under --max_bad_records."""
        return self.rec_base + (self.pf.source_pos
                                if self.pf is not None else 0)


def run_supervised_loop(args, *, sup, metrics, profiler, dataset, plan,
                        state: LoopState, train_step, on_rollback,
                        on_epoch_end, device=None, transform=None,
                        units_of=None, unit_name: str = "tokens",
                        avg_fmt: str = ".4f"):
    """The supervised epoch loop of the training CLIs: mid-epoch skip and
    accumulator restore, prefetched iteration (``data/prefetch.py``, the
    batches copied to ``device``), the supervisor's per-step protocol
    (fault hooks, NaN or spike rollback, cadence and preemption
    checkpoints), metrics, epoch summaries and the clean ``Preempted``
    exit. The CLIs keep what differs as callbacks:

      * ``train_step(item, state) -> (loss, payload)`` runs one step
        (routing its batch through ``sup.pre_step``); the payload of the
        last good step is kept on ``state.last``;
      * ``on_rollback(state)`` restores from the supervisor's anchor;
      * ``on_epoch_end(state, avg) -> checkpoint path`` is the epoch's
        tail;
      * ``units_of(item)`` sizes the throughput counter; ``transform``
        runs on the prefetch thread."""
    from dalle_pytorch_tpu_torch.data.prefetch import prefetch
    from dalle_pytorch_tpu_torch.resilience.supervisor import Preempted

    start_epoch = state.epoch
    skip0 = plan["skip_batches"] if plan else 0
    mid_meta = plan["meta"] if (plan and plan["mid_epoch"]) else {}
    try:
        for epoch in range(start_epoch, start_epoch + args.n_epochs):
            state.epoch = epoch
            skip = skip0 if epoch == start_epoch else 0
            state.train_loss = float(mid_meta.get("train_loss", 0.0)) \
                if skip else 0.0
            state.n_batches = int(mid_meta.get("n_batches", 0)) \
                if skip else 0
            state.epoch_i = int(mid_meta.get("step_in_epoch", skip)) \
                if skip else 0
            state.rec_base, state.pf = skip, None
            it = dataset.epoch(epoch)
            if skip:
                # the per-epoch order is a seeded function of the epoch:
                # skipping the completed prefix replays nothing
                it = itertools.islice(it, skip, None)
            state.pf = prefetch(it, depth=2, transform=transform,
                                device=device,
                                max_bad_records=args.max_bad_records,
                                on_event=lambda r: metrics.event(**r))
            for item in state.pf:
                gs = state.global_step
                profiler.maybe_start(gs)
                if getattr(args, "guard_transfers", False):
                    # the loss read below stays outside: it is the loop's
                    # one intentional host read a step
                    with transfer_guard(device):
                        loss, payload = train_step(item, state)
                else:
                    loss, payload = train_step(item, state)
                profiler.maybe_stop(gs)
                lv = float(loss)
                if sup.check_step(gs, lv) == sup.ROLLBACK:
                    on_rollback(state)
                    state.global_step += 1
                    state.epoch_i += 1
                    continue
                metrics.step(gs, lv, epoch=epoch,
                             units=units_of(item) if units_of else 0,
                             unit_name=unit_name)
                state.train_loss += lv
                state.n_batches += 1
                state.global_step += 1
                state.epoch_i += 1
                state.last = payload
                sup.end_step(state.global_step)
            if state.n_batches == 0:
                raise RuntimeError("empty dataset epoch")

            avg = state.train_loss / state.n_batches
            say(f"====> Epoch: {epoch} Average loss: {avg:{avg_fmt}}")
            state.epoch_i = 0  # epoch complete: saved meta must say so
            path = on_epoch_end(state, avg)
            if path:
                sup.register_checkpoint(path)
            mid_meta = {}
            skip0 = 0
    except Preempted as p:
        say(f"preempted — state saved to {p.path}; restart with "
            "--auto_resume to continue")
        return
    finally:
        sup.close()
        profiler.close()
        metrics.close()


def load_caption_dataset(args, mesh=None):
    """(vocab, CaptionDataset) from the --captions* flags, shared by
    train_dalle and train_clip; the vocabulary is saved beside the
    checkpoints as ``{name}-vocab.json`` by the primary rank. Each rank
    reads the pairs of its ``dp`` coordinate (``shard_for_host``): the
    ranks of one sp or pp group read the same rows."""
    from dalle_pytorch_tpu_torch.data.captions import (CaptionDataset,
                                                       load_caption_data)
    from dalle_pytorch_tpu_torch.data.prefetch import shard_for_host
    from dalle_pytorch_tpu_torch.parallel.multihost import is_primary
    vocab, data = load_caption_data(args.captions_only, args.captions,
                                    args.text_seq_len)
    if is_primary():
        vocab.save(os.path.join(args.models_dir, f"{args.name}-vocab.json"))
    data = list(shard_for_host(data, mesh=mesh))
    say(f"{len(data)} caption/image pairs on this host")
    return vocab, CaptionDataset(data, batch_size=args.batchSize,
                                 shuffle=True, seed=args.seed)


def make_run_mesh(args, world: int):
    """JAX's checks of the mesh flags (``setup_run``), then the mesh
    ``{dp, sp}``, ``{dp, pp}`` or ``{dp}`` over the ``world`` ranks."""
    from dalle_pytorch_tpu_torch.parallel.mesh import make_mesh
    n = args.dp or world
    if n != world:
        # one rank is one process on one device: the mesh is the world
        raise SystemExit(
            f"--dp {args.dp} does not match the world size ({world} "
            f"process{'es' if world != 1 else ''}): each process is one "
            "device, so start --dp processes (--num_processes, or "
            "torchrun's WORLD_SIZE)")
    sp = getattr(args, "sp", 0) or 1
    pp = getattr(args, "pp", 0) or 1
    if sp > 1 and pp > 1:
        raise SystemExit("--sp and --pp cannot be combined (pick one "
                         "model-parallel axis per run)")
    if sp > 1 and n % sp:
        raise SystemExit(f"--sp {sp} must divide the device count ({n})")
    if pp > 1 and n % pp:
        raise SystemExit(f"--pp {pp} must divide the device count ({n})")
    if sp > 1:
        axes = {"dp": n // sp, "sp": sp}
    elif pp > 1:
        axes = {"dp": n // pp, "pp": pp}
    else:
        axes = {"dp": n}
    return make_mesh(axes)


def setup_run(args, unit_name: str = "tokens", device=None):
    """-> (device, mesh, MetricsLogger, StepProfiler). Activates a
    ``DALLE_FAULTS`` plan, joins the
    process group when the flags or the environment name one
    (``parallel/multihost.py``; with --init_deadline_s each attempt is
    bounded and exhausted attempts exit with the bring-up record), makes
    the mesh (``make_run_mesh``), seeds numpy and makes the output
    directories. ``device`` is the rank's card unless the caller passes
    another (``device.resolve_device``)."""
    import json
    from dalle_pytorch_tpu_torch.parallel import multihost
    from dalle_pytorch_tpu_torch.resilience import faults
    from dalle_pytorch_tpu_torch.resilience.retry import BringupError
    from dalle_pytorch_tpu_torch.utils.debug import enable_nan_checks
    from dalle_pytorch_tpu_torch.utils.metrics import MetricsLogger
    from dalle_pytorch_tpu_torch.utils.profiling import StepProfiler
    faults.maybe_activate_from_env()
    try:
        multihost.initialize(
            coordinator_address=args.coordinator or None,
            num_processes=args.num_processes or None,
            process_id=args.process_id if args.process_id >= 0 else None,
            deadline_s=args.init_deadline_s or None,
            max_attempts=args.init_retries,
            on_event=lambda rec: say(f"[resilience] {rec}"),
            device=device)
    except BringupError as e:
        raise SystemExit(
            "backend bring-up failed: " + json.dumps(e.record)) from e
    except ValueError as e:
        raise SystemExit(str(e)) from e
    device = multihost.local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = make_run_mesh(args, multihost.process_count())
    enable_nan_checks(bool(args.nan_checks))
    np.random.seed(args.seed)
    metrics = MetricsLogger(args.metrics or None,
                            log_interval=args.log_interval,
                            n_devices=multihost.process_count(),
                            data_parallel=mesh.size("dp"))
    profiler = StepProfiler(args.profile_dir or None)
    if multihost.is_primary():
        os.makedirs(args.models_dir, exist_ok=True)
        os.makedirs(args.results_dir, exist_ok=True)
    multihost.barrier()
    return device, mesh, metrics, profiler


def save_checkpoint(path: str, model, optimizer, ema, *, mesh=None,
                    param_specs=None, **kw) -> str:
    """``checkpoint.save`` of the run's state, written once: every rank
    calls it (a pipeline's stages gather their layers to the first
    rank's), the primary writes, and the others wait at a barrier before
    anything reads what it wrote. Returns ``path``."""
    from dalle_pytorch_tpu_torch.parallel import multihost
    from dalle_pytorch_tpu_torch.parallel.train import checkpoint_state
    state = checkpoint_state(model, optimizer, ema, mesh, param_specs)
    if multihost.is_primary():
        params, opt, ema_ = state
        ckpt.save(path, params, opt_state=opt, ema=ema_, **kw)
    multihost.barrier()
    return path
