"""Leader election over the native KV store: TTL'd lease + add()-wins claims.
The port's copy of ``tpu_sandbox/runtime/election.py``: the same keys and
protocol, so members of either package contest one lease.

The cross-host elastic design (runtime/host_agent.py) needs exactly one
agent driving generation lifecycle at a time, and needs that role to move
when its holder dies mid-generation. The store has no compare-and-swap, so
the election builds on the two primitives it does have:

- ``add()`` is atomic: the first caller of ``add("leader/claim/<t>", 1)``
  sees 1 and owns term ``t``; every later caller sees >1 and lost.
- ``set_ttl()`` makes keys vanish server-side: the winner parks its id in
  ``leader/lease/<t>`` with a TTL and renews it; a leader that dies simply
  stops renewing, the lease evaporates, and any observer of the vacancy
  runs a new election at a higher term.

Multi-tenancy note: the election never namespaces its own keys — isolation
comes from the *client*. Hand it a job-scoped view (``kvstore.for_job``)
and two jobs sharing one store run fully independent elections under
``job/<id>/leader/*`` without this module knowing jobs exist.

Key layout (under ``prefix``, default ``leader``):

- ``<p>/term``       — highest *established* term (plain int, set by the
                       winner after its claim succeeds)
- ``<p>/claim/<t>``  — add()-wins tiebreaker for term ``t`` (persistent)
- ``<p>/lease/<t>``  — TTL'd lease for term ``t``; value = holder id

Two deliberate subtleties:

1. A claim winner that dies *between* claiming and establishing would brick
   its term forever (the claim key persists). Candidates therefore skip
   claimed-but-unestablished terms after giving the claimant ``claim_grace``
   seconds to finish — bounded stall, no deadlock.
2. A deposed leader must notice. Renewal first re-reads ``<p>/term``; if it
   moved past the holder's own term, a newer leader established itself (we
   were presumed dead, e.g. after a partition heals) and the holder abdicates
   instead of renewing a stale lease.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from tpu_sandbox_torch.runtime.kvstore import KVClient


@dataclass(frozen=True)
class LeaderInfo:
    term: int
    member_id: str


class LeaseElection:
    """One participant's view of the election. Call ``step()`` periodically
    (at least a few times per ``ttl``): it renews when leading, elects on a
    vacancy, and returns whether this member leads right now.
    """

    def __init__(
        self,
        kv: KVClient,
        member_id: int | str,
        *,
        ttl: float = 5.0,
        prefix: str = "leader",
        claim_grace: float | None = None,
    ):
        self.kv = kv
        self.member_id = str(member_id)
        if ttl <= 0:
            raise ValueError(f"lease ttl must be > 0, got {ttl}")
        self.ttl = ttl
        self.prefix = prefix
        # how long an unestablished claim bars its term before we move past
        # it (covers the claimant's claim->establish window; ttl is a safe
        # upper bound for two KV round-trips)
        self.claim_grace = ttl if claim_grace is None else claim_grace
        self._term = 0          # highest term this member has seen/held
        self._is_leader = False
        self._claim_seen: dict[int, float] = {}  # term -> patience deadline

    # -- key layout ---------------------------------------------------------

    def _term_key(self) -> str:
        return f"{self.prefix}/term"

    def _claim_key(self, term: int) -> str:
        return f"{self.prefix}/claim/{term}"

    def _lease_key(self, term: int) -> str:
        return f"{self.prefix}/lease/{term}"

    # -- observation --------------------------------------------------------

    @property
    def is_leader(self) -> bool:
        return self._is_leader

    @property
    def term(self) -> int:
        return self._term

    def stored_term(self) -> int:
        raw = self.kv.try_get(self._term_key())
        return 0 if raw is None else int(raw)

    def observe(self) -> LeaderInfo | None:
        """Current leader per the store, or None when the lease is vacant
        (expired, resigned, or nobody ever won)."""
        term = self.stored_term()
        if term == 0:
            return None
        raw = self.kv.try_get(self._lease_key(term))
        if raw is None:
            return None
        return LeaderInfo(term, raw.decode())

    # -- participation ------------------------------------------------------

    def step(self, *, candidate: bool = True) -> bool:
        """Renew / observe / elect, returning True iff this member leads.

        ``candidate=False`` observes and renews but never starts a new
        election — agents use it to bias the initial election toward a
        designated member without forfeiting failover.
        """
        stored = self.stored_term()
        if self._is_leader:
            if stored == self._term:
                # still the established leader: renew before the lease lapses
                self.kv.set_ttl(
                    self._lease_key(self._term), self.member_id, self.ttl
                )
                return True
            # a higher term established itself while we were silent
            self._is_leader = False
            self._term = max(self._term, stored)
        current = self.observe()
        if current is not None:
            self._term = current.term
            self._is_leader = current.member_id == self.member_id
            return self._is_leader
        if not candidate:
            return False
        return self._run_election(stored)

    def _run_election(self, established: int) -> bool:
        term = self._candidate_term(established)
        if term is None:
            return False  # an in-flight claimant still has grace to finish
        if self.kv.add(self._claim_key(term), 1) != 1:
            # lost the add() race; the winner gets claim_grace to establish
            self._claim_seen.setdefault(
                term, time.monotonic() + self.claim_grace
            )
            return False
        # Won the claim. Guard against a higher term having established
        # while we raced (then our lease would be ignored anyway): abdicate.
        now_stored = self.stored_term()
        if now_stored >= term:
            self._term = now_stored
            return False
        # Establish order matters: term first, lease second. A winner dying
        # between the two leaves term=t with no lease -> observers see a
        # vacancy at t and elect t+1; the reverse order could strand a live
        # lease nobody looks at.
        self.kv.set(self._term_key(), str(term))
        self.kv.set_ttl(self._lease_key(term), self.member_id, self.ttl)
        self._term, self._is_leader = term, True
        # hygiene: retire tiebreaker keys for terms at/below ours so the
        # claim namespace doesn't grow forever across failovers
        for k in self.kv.keys(f"{self.prefix}/claim/"):
            try:
                t = int(k.rsplit("/", 1)[1])
            except ValueError:
                continue
            if t < term:
                self.kv.delete(k)
        return True

    def _candidate_term(self, established: int) -> int | None:
        """Next electable term above ``established``: skips terms whose claim
        key exists (somebody won the tiebreak there), but only after giving
        that claimant ``claim_grace`` seconds to establish — returns None
        while still inside a claimant's grace window."""
        term = established + 1
        now = time.monotonic()
        while self.kv.try_get(self._claim_key(term)) is not None:
            deadline = self._claim_seen.setdefault(
                term, now + self.claim_grace
            )
            if now < deadline:
                return None
            term += 1
        return term

    def resign(self) -> None:
        """Voluntarily drop the lease so followers elect immediately instead
        of waiting out the TTL."""
        if self._is_leader:
            self.kv.delete(self._lease_key(self._term))
            self._is_leader = False
