"""The port's leader election (tpu_sandbox_torch/runtime/election.py)
through the scenarios of tests/test_election.py, run against both
packages (``impl``: ``jax`` is ``tpu_sandbox.runtime``, ``torch`` the
port's copy over its own C++ store): acquire, renew, expire, steal,
depose, resign and the orphaned-claim grace window, in-process against
one KV server, short TTLs. Then the two packages contest one lease in one
store, and exactly one member wins."""

import importlib
import time
from types import SimpleNamespace

import pytest

from torch_threads import one_torch_thread  # noqa: F401

PACKAGES = {"jax": "tpu_sandbox", "torch": "tpu_sandbox_torch"}
# KV round trips are sub-millisecond, but a TTL still has to dwarf a
# handful of them plus scheduler jitter under a loaded test box.
TTL = 0.5


def _modules(pkg: str) -> SimpleNamespace:
    return SimpleNamespace(**{m: importlib.import_module(f"{pkg}.runtime.{m}")
                              for m in ("election", "kvstore")})


@pytest.fixture(params=sorted(PACKAGES))
def impl(request):
    return _modules(PACKAGES[request.param])


@pytest.fixture()
def kv(impl):
    with impl.kvstore.KVServer() as srv:
        clients = []

        def make():
            c = impl.kvstore.KVClient(port=srv.port)
            clients.append(c)
            return c

        yield make
        for c in clients:
            c.close()


def _member(impl, kv, mid, **kw):
    kw.setdefault("ttl", TTL)
    return impl.election.LeaseElection(kv(), mid, **kw)


def test_first_candidate_acquires_term_1(impl, kv):
    a = _member(impl, kv, "a")
    assert a.step() is True
    assert a.is_leader and a.term == 1
    assert a.observe() == impl.election.LeaderInfo(1, "a")


def test_follower_observes_without_stealing(impl, kv):
    a, b = _member(impl, kv, "a"), _member(impl, kv, "b")
    assert a.step() is True
    assert b.step() is False           # sees a's live lease, follows
    assert b.term == 1 and not b.is_leader
    assert b.observe() == impl.election.LeaderInfo(1, "a")


def test_renewal_keeps_lease_past_ttl(impl, kv):
    a, b = _member(impl, kv, "a"), _member(impl, kv, "b")
    assert a.step() is True
    deadline = time.monotonic() + 3 * TTL
    while time.monotonic() < deadline:
        assert a.step() is True        # renew well inside the TTL
        assert b.step() is False       # never a vacancy to elect into
        time.sleep(TTL / 3)
    assert a.term == 1                 # renewed, not re-won


def test_expired_lease_is_stolen_at_higher_term(impl, kv):
    a, b = _member(impl, kv, "a"), _member(impl, kv, "b")
    assert a.step() is True
    time.sleep(TTL * 2)                # a stops renewing: lease evaporates
    assert b.step() is True
    assert b.term == 2                 # new term, not a resurrection of 1
    assert b.observe() == impl.election.LeaderInfo(2, "b")


def test_stale_leader_abdicates_after_takeover(impl, kv):
    a, b = _member(impl, kv, "a"), _member(impl, kv, "b")
    assert a.step() is True
    time.sleep(TTL * 2)
    assert b.step() is True            # term 2 established
    # a comes back (partition healed): sees the advanced term, steps down
    assert a.step() is False
    assert not a.is_leader and a.term == 2
    assert b.step() is True            # b unaffected


def test_non_candidate_never_elects_but_still_follows(impl, kv):
    b = _member(impl, kv, "b")
    assert b.step(candidate=False) is False
    assert b.observe() is None         # vacancy left untouched
    a = _member(impl, kv, "a")
    assert a.step() is True
    assert b.step(candidate=False) is False
    assert b.term == 1                 # does follow the winner it observes


def test_resign_hands_off_without_waiting_out_ttl(impl, kv):
    a, b = _member(impl, kv, "a"), _member(impl, kv, "b")
    assert a.step() is True
    a.resign()
    assert b.step() is True            # immediate: no TTL wait needed
    assert b.term == 2


def test_orphaned_claim_blocks_only_for_grace(impl, kv):
    """A claimant that dies between claim and establish leaves a
    persistent claim key: candidates wait out claim_grace on that term,
    then skip it."""
    store = kv()
    store.add("leader/claim/1", 1)     # orphan: claimed, never established
    b = impl.election.LeaseElection(kv(), "b", ttl=TTL, claim_grace=0.4)
    t0 = time.monotonic()
    assert b.step() is False           # inside the orphan's grace window
    while not b.step():
        assert time.monotonic() - t0 < 5.0, "grace window never expired"
        time.sleep(0.05)
    assert time.monotonic() - t0 >= 0.3   # did honour the grace
    assert b.term == 2                 # skipped the bricked term entirely


def test_claim_race_has_exactly_one_winner(impl, kv):
    # generous ttl: five sequential steps must not outlive the lease, or a
    # "second winner" is just a legal steal
    members = [_member(impl, kv, str(i), ttl=5.0) for i in range(5)]
    results = [m.step() for m in members]
    assert sum(results) == 1
    leader = members[results.index(True)]
    assert all(m.term == leader.term for m in members)
    assert [m.step() for m in members] == results


# -- the two packages on one store ------------------------------------------

@pytest.mark.parametrize("server_pkg", sorted(PACKAGES))
def test_both_packages_contest_one_lease(server_pkg):
    """Members of JAX's election and of the port's, interleaved on one
    store (either package's server), elect exactly one leader; when it
    resigns, a member of the other package takes the next term, and the
    deposed side follows it."""
    jax_m, torch_m = _modules("tpu_sandbox"), _modules("tpu_sandbox_torch")
    server = _modules(PACKAGES[server_pkg]).kvstore.KVServer()
    clients = []
    try:
        members = []
        for i in range(6):
            mods = jax_m if i % 2 == 0 else torch_m
            c = mods.kvstore.KVClient(port=server.port)
            clients.append(c)
            members.append(mods.election.LeaseElection(c, f"m{i}", ttl=5.0))
        won = [m.step() for m in members]
        assert sum(won) == 1
        leader = members[won.index(True)]
        assert all(m.term == 1 for m in members)
        seen = {(i.term, i.member_id) for i in (m.observe() for m in members)}
        assert seen == {(1, leader.member_id)}
        leader.resign()
        other = next(m for m in members
                     if type(m) is not type(leader))
        assert other.step() is True and other.term == 2
        assert [m.step() for m in members].count(True) == 1
        assert leader.step() is False and leader.term == 2
    finally:
        for c in clients:
            c.close()
        server.stop()
