"""Failure detection: heartbeats, a watchdog, bounded-wait rendezvous and
the finite-loss sanitizers. The port's copy of
``tpu_sandbox/runtime/watchdog.py``, plus ``assert_finite`` and
``guarded_step`` of ``tpu_sandbox/utils/debugging.py`` written on tensors.

The reference has none of this (SURVEY §5 "Failure detection: Absent — a
dead rank just hangs the group"): `init_process_group` has no timeout
wired, and a crashed worker leaves the others blocked in the next
collective forever. This subsystem closes that gap the way torchelastic's
health layer does, but over this framework's own native KV store
(native/src/kvstore.cpp) rather than a side service:

- ``Heartbeat``     — per-rank daemon thread stamping ``hb/{rank}`` with a
                      monotonic-ish wall timestamp every ``interval``.
- ``Watchdog``      — any process polls all ranks' stamps with the
                      non-blocking try-get; a rank whose stamp is older
                      than ``timeout`` (or never appeared after its grace
                      period) is reported dead. Fail-fast, not hang.
- ``wait_for_world``— rendezvous with a deadline: returns when all ranks
                      checked in, raises ``RendezvousTimeout`` listing the
                      missing ranks otherwise (vs the reference's silent
                      infinite block).

Deliberately collective-free: detection must keep working when the
accelerator side is wedged, so everything here is host-side TCP.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from tpu_sandbox_torch.runtime.kvstore import KVClient


class RendezvousTimeout(RuntimeError):
    pass


class DeadRankError(RuntimeError):
    pass


def _hb_key(rank: int) -> str:
    return f"hb/{rank}"


class Heartbeat:
    """Background thread publishing this rank's liveness.

    Usage (per rank)::

        hb = Heartbeat(client, rank, interval=1.0)
        hb.start()
        ...
        hb.stop()
    """

    def __init__(
        self,
        client: KVClient,
        rank: int,
        interval: float = 1.0,
        *,
        key: str | None = None,
    ):
        self._owner = client
        self.rank = rank
        self.interval = interval
        # default key is the per-rank health-plane slot; host agents pass
        # their own (e.g. "agent_hb/<id>") to publish on a separate plane
        self.key = _hb_key(rank) if key is None else key
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._clone: KVClient | None = None

    @property
    def client(self) -> KVClient:
        """The beat connection: a dedicated clone of the owner's client (the
        owner's blocking get() would otherwise hold the shared request lock
        and starve beats into a false death verdict). Created on first use,
        closed by stop() so repeated start/stop cycles don't leak sockets."""
        if self._clone is None:
            self._clone = self._owner.clone()
        return self._clone

    def beat_once(self) -> None:
        self.client.set(self.key, repr(time.time()).encode())

    def start(self) -> "Heartbeat":
        if self._thread is not None:
            return self
        self._stop.clear()  # restartable after stop()
        self.beat_once()  # synchronous first beat: visible before start returns

        def run():
            while not self._stop.wait(self.interval):
                try:
                    self.beat_once()
                except Exception:
                    return  # store gone; the watchdog will notice our silence
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def stop(self, *, deregister: bool = False) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            if t.is_alive():
                # beat thread is wedged inside a native request (store not
                # answering). Closing its fd now would race OS fd reuse and
                # let the unwedged thread corrupt a foreign connection, so
                # leave the clone open and keep _thread set — start() stays
                # a no-op and the thread exits on its own once it unblocks
                # (the stop event is already set).
                return
            self._thread = None
        if deregister:
            try:
                self.client.delete(self.key)
            except Exception:
                pass
        if self._clone is not None:
            self._clone.close()
            self._clone = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


@dataclass
class RankHealth:
    rank: int
    alive: bool
    last_seen: float | None  # remote wall stamp of last beat (informational)
    age: float | None = field(default=None)  # local secs since stamp changed


class Watchdog:
    """Poll-based dead-rank detector over the heartbeat keys.

    Liveness is judged **skew-free**: the watchdog never compares the remote
    stamp against its own wall clock (cross-host clock skew would then read
    as death or mask one). Instead it remembers, per rank, when *it* last
    observed the stamp change; a rank is dead when its stamp has been frozen
    for > ``timeout`` of the watchdog's local seconds. The remote stamp is
    only an opaque change-token (plus an informational ``last_seen``).
    """

    def __init__(
        self,
        client: KVClient,
        world_size: int,
        *,
        timeout: float = 10.0,
        grace: float | None = None,
        key_fn: "Callable[[int], str]" = _hb_key,
    ):
        self.client = client
        self.world_size = world_size
        self.timeout = timeout
        # key_fn maps member index -> heartbeat key; the default watches the
        # per-rank plane, host agents watch each other via "agent_hb/<id>"
        self.key_fn = key_fn
        # ranks that never wrote at all get `grace` seconds from watchdog
        # construction before they count as dead (startup skew)
        self.grace = timeout if grace is None else grace
        self._born = time.time()
        # rank -> (last stamp bytes, local time we saw it change)
        self._observed: dict[int, tuple[bytes, float]] = {}

    def check(self) -> list[RankHealth]:
        now = time.time()
        report = []
        for rank in range(self.world_size):
            raw = self.client.try_get(self.key_fn(rank))
            if raw is None:
                alive = (now - self._born) < self.grace
                report.append(RankHealth(rank, alive, None))
                continue
            prev = self._observed.get(rank)
            if prev is None or prev[0] != raw:
                self._observed[rank] = (raw, now)
                changed_at = now
            else:
                changed_at = prev[1]
            age = now - changed_at
            report.append(
                RankHealth(rank, age < self.timeout, float(raw.decode()), age)
            )
        return report

    def dead_ranks(self) -> list[int]:
        return [h.rank for h in self.check() if not h.alive]

    def assert_all_alive(self) -> None:
        dead = self.dead_ranks()
        if dead:
            raise DeadRankError(
                f"rank(s) {dead} missed heartbeats for >{self.timeout}s "
                f"(world_size={self.world_size})"
            )

    def watch(
        self, *, poll: float = 1.0, stop: threading.Event | None = None
    ) -> threading.Thread:
        """Spawn a monitor thread that raises into a stored exception slot;
        read it via ``self.failure`` (threads can't raise across)."""
        self.failure: DeadRankError | None = None
        stop = stop or threading.Event()
        self._watch_stop = stop

        def run():
            while not stop.wait(poll):
                try:
                    self.assert_all_alive()
                except DeadRankError as e:
                    self.failure = e
                    return
        t = threading.Thread(target=run, daemon=True)
        t.start()
        return t

    def stop_watching(self) -> None:
        ev = getattr(self, "_watch_stop", None)
        if ev is not None:
            ev.set()


def wait_for_world(
    client: KVClient,
    world_size: int,
    rank: int,
    *,
    timeout: float = 60.0,
    key: str = "rendezvous",
    poll: float = 0.05,
) -> None:
    """Deadline-bounded rendezvous: every rank announces itself, then waits
    for the full world or raises ``RendezvousTimeout`` naming who's missing.

    The reference's analogue is ``dist.init_process_group`` blocking forever
    when a rank never starts (SURVEY §5); torch's fix is a timeout kwarg,
    ours is this function in front of ``bootstrap.init``.

    Generation-scoped: each call bumps this rank's join counter and waits
    for every rank's counter to reach the same generation, so re-rendezvous
    after an elastic restart genuinely waits for everyone again instead of
    being satisfied by the previous round's leftover keys.
    """
    gen = client.add(f"{key}/gen/{rank}", 1)
    deadline = time.time() + timeout
    while True:
        gens = []
        for r in range(world_size):
            raw = client.try_get(f"{key}/gen/{r}")
            gens.append(0 if raw is None else int(raw))
        if all(g >= gen for g in gens):
            return
        if time.time() >= deadline:
            missing = sorted(
                r for r, g in enumerate(gens) if g < gen
            )
            raise RendezvousTimeout(
                f"rank {rank}: only {world_size - len(missing)}/{world_size} "
                f"ranks joined generation {gen} within {timeout}s; "
                f"missing ranks: {missing}"
            )
        time.sleep(poll)


# -- numerical sanitizers (tpu_sandbox/utils/debugging.py:50-119) ----------


class NonFiniteError(RuntimeError):
    def __init__(self, msg: str, bad_paths: list[str]):
        super().__init__(msg)
        self.bad_paths = bad_paths


def _named_leaves(tree, prefix: str = ""):
    """(path, leaf) of a tensor tree: a module (its state dict), a mapping,
    a list or tuple, or one tensor or array; paths join keys with '/'."""
    if isinstance(tree, torch.nn.Module):
        tree = {k.replace(".", "/"): v for k, v in tree.state_dict().items()}
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}/{i}" if prefix else str(i))
    elif tree is not None:
        yield prefix, tree


def finite_report(tree) -> list[str]:
    """Paths of floating leaves holding any NaN or Inf (one host sync a
    leaf; bf16 and fp8 tensors count as floating)."""
    bad: list[str] = []
    for path, leaf in _named_leaves(tree):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(
            np.asarray(leaf))
        if not (t.is_floating_point() or t.is_complex()):
            continue
        n = int((~torch.isfinite(t)).sum())
        if n:
            bad.append(f"{path} ({n}/{t.numel()} non-finite)")
    return bad


def assert_finite(tree, name: str = "tree") -> None:
    bad = finite_report(tree)
    if bad:
        raise NonFiniteError(
            f"{name}: non-finite values in {len(bad)} leaves:\n  "
            + "\n  ".join(bad),
            bad,
        )


def guarded_step(step_fn, state=None, *, name: str = "train_step"):
    """Wrap ``step_fn(*batch) -> loss`` with a per-step loss check; on a
    non-finite loss, diagnose ``state`` (a module, a tensor tree or
    anything with a ``model``) too so the error names the poisoned
    leaves. One scalar device-to-host sync a step: for debugging runs."""
    calls = {"n": 0}

    def wrapped(*args, **kwargs):
        loss = step_fn(*args, **kwargs)
        step = calls["n"]
        calls["n"] += 1
        loss_t = torch.as_tensor(loss).detach()
        if not bool(torch.isfinite(loss_t).all()):
            target = getattr(state, "model", state)
            detail = [] if target is None else finite_report(target)
            raise NonFiniteError(
                f"{name}: non-finite loss {loss_t.reshape(-1)[:4].tolist()} "
                f"at step {step}" + (
                    "; poisoned state leaves:\n  " + "\n  ".join(detail)
                    if detail else
                    " (state still finite — loss-only blowup)"),
                detail,
            )
        return loss

    return wrapped
