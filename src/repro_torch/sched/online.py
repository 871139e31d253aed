"""Online learning in the serving path (port of ``repro.sched.online``):
realized transitions -> replay ring -> background policy refresh with
double-buffered params.

  * **TransitionRecorder** observes every SERVED decision through the
    daemon's ``decision_hook``: one host-side deque append, no device work
    on the serving path, so attaching it adds no scoring launch.
    ``drain()`` turns the recorded ``(pod, action)`` stream into replay
    rows with the offline arithmetic: a shadow ``ClusterState`` advanced
    through ``core.train_rl.realized_transition`` (afterstate features,
    the realized Table-3/5 reward, ``REWARD_SCALE`` targets, weight-0
    drops), written into the fused ring in chunks of ``DRAIN_CHUNK``
    (``replay_add(..., n_valid=...)``).  The ring equals the offline fold
    of the same stream.
  * **FleetTransitionRecorder** is its job->host analogue
    (``FleetSubstrate``): a bind adds the job's six-column delta to the
    chosen host of a shadow ``FleetState``, and the reward is the literal
    Table-3 ``rewards.sdqn_reward`` over the raw fleet rows.
  * **OnlineRefresher** runs ``policy.make_train_step`` batches off that
    ring against a BACK parameter buffer while the daemon scores from its
    FRONT buffer, then publishes the new tree with one reference
    assignment (``daemon.set_params``).  torch tensors are mutable, so the
    double buffer rests on the learner writing nothing in place: its step
    (``optim.adam_update``) builds new tensors, and the front tree the
    daemon reads is never changed.  The daemon reads its params once per
    batch cut, so a batch never mixes old and new params.  Targets are
    the realized rewards (bandit semantics, the literal Table-4 update).

External churn that the decision stream does not carry (``fail_node``
evictions, manual ``unbind``) desyncs the shadow: ``resync(live)`` after
it.

    rec = TransitionRecorder(state, cfg)
    daemon = PlacementDaemon(sub, params, decision_hook=rec.record)
    ref = OnlineRefresher(daemon, rec)
    ... replay_trace(daemon, t_s, pods) ...   # serving thread
    ref.step()                                # or ref.start() / stop()
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import env as kenv, policy as policy_mod, rewards
from repro_torch.core import train_rl
from repro_torch.core.replay import (Replay, replay_add, replay_init,
                                     replay_sample)
from repro_torch.core.types import FEATURE_DIM, EnvConfig, PodSpec
from repro_torch.device import resolve_device
from repro_torch.sched import placement as _pl

__all__ = [
    "DRAIN_CHUNK", "FleetTransitionRecorder", "OnlineRefresher",
    "TransitionRecorder",
]

# transitions converted per drain chunk (the unit ``max_chunks`` counts)
DRAIN_CHUNK = 64


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class _Recorder:
    """The shared half of both recorders: the pending deque, chunked
    drains and ``resync``; subclasses convert one chunk."""

    def __init__(self, capacity: int, chunk: int, device):
        self.device = resolve_device(device)
        self.buffer: Replay = replay_init(capacity, n_features=FEATURE_DIM,
                                          lane=1, device=self.device)
        self._pending: collections.deque = collections.deque()
        self._chunk = chunk
        self.recorded = 0
        self.drained = 0

    def record(self, work, action: int) -> None:
        """The daemon's ``decision_hook``: O(1), no device work."""
        self._pending.append((work, int(action)))
        self.recorded += 1

    @property
    def pending(self) -> int:
        return len(self._pending)

    def drain(self, max_chunks: Optional[int] = None) -> int:
        """Convert recorded decisions into ring rows, ``DRAIN_CHUNK`` at a
        time; returns the number written.  ``max_chunks`` bounds the device
        work of one call (a refresh cycle on a device it shares with the
        serving path); the rest stays pending for the next call."""
        n_total = n_chunks = 0
        while self._pending and (max_chunks is None or n_chunks < max_chunks):
            n_chunks += 1
            take = [self._pending.popleft()
                    for _ in range(min(len(self._pending), self._chunk))]
            feats, targets, weights = self._convert(take)
            self.buffer = replay_add(self.buffer, feats, targets, weights,
                                     n_valid=len(take))
            n_total += len(take)
        self.drained += n_total
        return n_total

    def resync(self, live) -> None:
        """Rebase the shadow on the daemon's live buffer after churn the
        decision stream does not carry; drains first, so that what was
        recorded is charged against the state it was served under."""
        self.drain()
        self._shadow = self._load(live)


class TransitionRecorder(_Recorder):
    """Daemon decisions -> fused replay ring, with the offline arithmetic.

    ``state`` / ``cfg`` are the substrate's initial ``ClusterState`` (of
    tensors, or the daemon's numpy live buffer) and ``EnvConfig``; the
    shadow lives on ``device`` (the card unless ``"cpu"``)."""

    def __init__(self, state, cfg: EnvConfig, capacity: int = 4096,
                 reward_fn: Optional[Callable] = None,
                 chunk: int = DRAIN_CHUNK, device=None):
        super().__init__(capacity, chunk, device)
        self.cfg = cfg
        self._reward_fn = (reward_fn if reward_fn is not None
                           else rewards.make_reward_fn())
        self._shadow = self._load(state)

    def _load(self, state):
        return convert.state_from_numpy([_host(x) for x in state],
                                        self.device)

    def _convert(self, take):
        cols = torch.tensor([[float(x) for x in pod] for pod, _ in take],
                            dtype=torch.float32, device=self.device)
        actions = torch.tensor([a for _, a in take], dtype=torch.int32,
                               device=self.device)
        feats, targets = [], []
        for i in range(len(take)):
            self._shadow, stored, r = train_rl.realized_transition(
                self._shadow, PodSpec(*cols[i]), actions[i], self.cfg,
                self._reward_fn)
            feats.append(stored)
            targets.append(r)
        # drops store with weight 0: their afterstate is a clamped gather
        return (torch.stack(feats), torch.stack(targets),
                (actions >= 0).to(torch.float32))

    def warmup(self) -> None:
        """Run the drain's arithmetic once on a pad row (action -1) and
        discard it: the shadow and the ring are unchanged."""
        train_rl.realized_transition(
            self._shadow, PodSpec(0.0, 0.0, 0.0, 0.0),
            torch.tensor(-1, dtype=torch.int32, device=self.device),
            self.cfg, self._reward_fn)


class FleetTransitionRecorder(_Recorder):
    """The job->host analogue of ``TransitionRecorder``: a float32 shadow
    ``FleetState`` (``num_jobs`` too), the reward the literal Table-3
    ``sdqn_reward`` over the raw fleet rows with ``efficiency_weight``."""

    def __init__(self, fleet: _pl.FleetState, capacity: int = 4096,
                 efficiency_weight: float = 5.0, chunk: int = DRAIN_CHUNK,
                 device=None):
        super().__init__(capacity, chunk, device)
        self.efficiency_weight = efficiency_weight
        self._shadow = self._load(fleet)

    def _load(self, fleet):
        return _pl.FleetState(*(torch.tensor(_host(x), dtype=torch.float32,
                                             device=self.device)
                                for x in fleet))

    def _step(self, fl, delta, action):
        onehot = (torch.arange(fl.cpu_pct.shape[0], device=self.device)
                  == action).to(torch.float32)    # action < 0: all zero
        fl2 = fl._replace(cpu_pct=fl.cpu_pct + onehot * delta[0],
                          mem_pct=fl.mem_pct + onehot * delta[1],
                          job_util_pct=fl.job_util_pct + onehot * delta[2],
                          num_jobs=fl.num_jobs + onehot * delta[5])
        after = fl2.features()
        a = torch.clamp(action, min=0)
        r = rewards.sdqn_reward(after, a,
                                efficiency_weight=self.efficiency_weight,
                                before_feats=fl.features())
        stored = kenv.normalize_features(after[a.to(torch.int64)])
        return fl2, stored, r * train_rl.REWARD_SCALE

    def _convert(self, take):
        deltas = _pl.job_deltas([j for j, _ in take], self.device)
        actions = torch.tensor([a for _, a in take], dtype=torch.int32,
                               device=self.device)
        feats, targets = [], []
        for i in range(len(take)):
            self._shadow, stored, r = self._step(self._shadow, deltas[i],
                                                 actions[i])
            feats.append(stored)
            targets.append(r)
        return (torch.stack(feats), torch.stack(targets),
                (actions >= 0).to(torch.float32))

    def warmup(self) -> None:
        """One pad row through the drain's arithmetic, discarded."""
        self._step(self._shadow, torch.zeros(6, device=self.device),
                   torch.tensor(-1, dtype=torch.int32, device=self.device))


class OnlineRefresher:
    """Background policy refresh off a recorder's ring, double-buffered.

    ``step()`` is one cycle: drain the recorder (at most
    ``drain_chunks_per_step`` chunks), sample a batch (indices from a
    generator seeded with ``seed``, on the ring's device), take one
    ``policy.make_train_step`` step on the BACK params and publish them to
    the daemon (``set_params``).  Call it inline, or ``start()`` a thread
    that cycles every ``min_interval_s``; its launches go to the device
    the daemon scores on, and the drain bound caps how long one cycle
    holds it.  Adam moments start fresh from the served params
    (``policy.make_opt_state``) and persist across cycles."""

    def __init__(self, daemon, recorder, spec=None, batch_size: int = 128,
                 min_interval_s: float = 0.0, seed: int = 0,
                 drain_chunks_per_step: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.daemon = daemon
        self.recorder = recorder
        spec = spec if spec is not None else policy_mod.get("mlp")
        self._step_fn = policy_mod.make_train_step(spec)
        self._back = daemon._params           # back buffer starts == front
        self._opt = policy_mod.make_opt_state(self._back)
        self._gen = torch.Generator(
            device=recorder.buffer.data.device).manual_seed(seed)
        self.batch_size = batch_size
        self.min_interval_s = min_interval_s
        self.drain_chunks_per_step = drain_chunks_per_step
        self._clock = clock
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.steps = 0
        self.swaps = 0
        self.last_loss: Optional[float] = None

    @property
    def params(self) -> dict:
        """The back buffer (the freshest learned params)."""
        return self._back

    def warmup(self) -> None:
        """Run the drain and train arithmetic once off the serving clock
        and discard it: nothing is published, and the back buffer, the
        optimizer state and the sampling generator are untouched."""
        self.recorder.warmup()
        idx = torch.zeros((self.batch_size,), dtype=torch.int64,
                          device=self.recorder.buffer.data.device)
        feats, targets, w = replay_sample(self.recorder.buffer, idx)
        self._step_fn(self._back, self._opt, feats, targets, w)

    def step(self) -> Optional[float]:
        """One drain / train / publish cycle; returns the batch loss, or
        None while the ring is empty."""
        self.recorder.drain(max_chunks=self.drain_chunks_per_step)
        buf = self.recorder.buffer
        if buf.size == 0:
            return None
        idx = torch.randint(0, buf.size, (self.batch_size,),
                            generator=self._gen, device=buf.data.device)
        feats, targets, w = replay_sample(buf, idx)
        # the step builds new tensors: the front tree the daemon may be
        # scoring with right now is never written
        self._back, self._opt, loss, _ = self._step_fn(
            self._back, self._opt, feats, targets, w)
        self.daemon.set_params(self._back)    # the reference flip
        self.steps += 1
        self.swaps += 1
        self.last_loss = float(loss)
        return self.last_loss

    def start(self) -> None:
        """Spawn the background refresh thread (idempotent)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                t0 = self._clock()
                self.step()
                lag = self.min_interval_s - (self._clock() - t0)
                if lag > 0:
                    self._stop.wait(lag)
                else:
                    time.sleep(0)            # yield to the serving thread

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="online-refresher")
        self._thread.start()

    def stop(self) -> None:
        """Stop and join the refresh thread (no-op when not running)."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
