"""Unit tests for the survivable control plane: lease
lifecycle and expiry, blacklist/role truth, CRC-framed journal + manifest
commits, driver-restart recovery with live-lease re-adoption, epoch fencing
of stale writers, torn-manifest/torn-journal fallback, and the deterministic
heartbeat aggregation tree election."""

import json
import os
import zlib

import pytest

from tensorflowonspark_tpu_torch import chaos, registry


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class TestLeaseLifecycle:
    def test_join_renew_leave(self):
        clk = FakeClock()
        reg = registry.MembershipRegistry(ttl=10, clock=clk)
        reg.begin_generation({0: ("worker", 0), 1: ("worker", 1)})
        assert reg.epoch == 1
        reg.join(0, "worker", 0)
        reg.join(1, "worker", 1)
        assert reg.live_members() == [0, 1]
        assert reg.leases_active() == 2
        assert reg.role_map() == {"worker:0": 0, "worker:1": 1}
        reg.leave(1, reason="done")
        assert reg.live_members() == [0]

    def test_renew_requires_beat_progress(self):
        """Re-reading a dead child's frozen counter must not renew."""
        reg = registry.MembershipRegistry(ttl=10)
        reg.begin_generation()
        reg.join(0)
        assert reg.renew(0, beat=3) is True
        assert reg.renew(0, beat=3) is False  # same value: no progress
        assert reg.renew(0, beat=4) is True

    def test_expiry_after_ttl_without_renewal(self):
        clk = FakeClock()
        reg = registry.MembershipRegistry(ttl=10, clock=clk)
        reg.begin_generation()
        reg.join(0)
        reg.join(1)
        reg.renew(0, beat=1)
        reg.renew(1, beat=1)
        clk.advance(11)
        reg.renew(0, beat=2)  # only node 0 keeps beating
        expired = reg.expire_stale()
        assert [eid for eid, _ in expired] == [1]
        age = expired[0][1]
        assert age > 10
        assert reg.live_members() == [0]

    def test_expiry_survives_journal_io_failure(self, tmp_path, monkeypatch):
        """Failure detection must not depend on the disk: a journal append
        that raises (disk full, unwritable dir) still returns the in-memory
        expiries — otherwise the members flip to ``expired`` state but are
        never reported, and the loss goes permanently unnoticed."""
        clk = FakeClock()
        reg = registry.MembershipRegistry(ttl=10, journal_dir=str(tmp_path), clock=clk)
        reg.begin_generation()
        reg.join(0)
        reg.renew(0, beat=1)
        clk.advance(11)

        def boom(record):
            raise OSError("disk full")

        monkeypatch.setattr(reg, "_journal_locked", boom)
        expired = reg.expire_stale()
        assert [eid for eid, _ in expired] == [0]
        assert reg.live_members() == []

    def test_member_that_never_beat_is_exempt(self):
        """Slow child startup is the launch timeout's concern, not a lease
        violation (historical watchdog parity)."""
        clk = FakeClock()
        reg = registry.MembershipRegistry(ttl=5, clock=clk)
        reg.begin_generation()
        reg.join(0)
        clk.advance(1000)
        assert reg.expire_stale() == []
        assert reg.live_members() == [0]

    def test_expired_member_readopted_on_new_beat(self):
        clk = FakeClock()
        reg = registry.MembershipRegistry(ttl=5, clock=clk)
        reg.begin_generation()
        reg.join(0)
        reg.renew(0, beat=1)
        clk.advance(6)
        assert [e for e, _ in reg.expire_stale()] == [0]
        assert reg.renew(0, beat=2) is True  # long flap: the node came back
        assert reg.live_members() == [0]

    def test_left_member_does_not_renew(self):
        reg = registry.MembershipRegistry(ttl=5)
        reg.begin_generation()
        reg.join(0)
        reg.leave(0)
        assert reg.renew(0, beat=1) is False

    def test_blacklist_and_forgive(self):
        reg = registry.MembershipRegistry()
        reg.blacklist(3, reason="repeated loss")
        assert reg.is_blacklisted(3)
        assert reg.blacklisted() == [3]
        reg.forgive(3)
        assert not reg.is_blacklisted(3)

    def test_generation_bumps_epoch_and_clears_members(self):
        reg = registry.MembershipRegistry()
        reg.begin_generation({0: ("chief", 0)})
        reg.join(0, "chief", 0)
        reg.begin_generation({0: ("chief", 0), 1: ("worker", 0)})
        assert reg.epoch == 2
        assert reg.live_members() == []  # relaunch: fresh roster
        assert reg.roles() == {0: ("chief", 0), 1: ("worker", 0)}


class TestJournalRecovery:
    def test_recover_readopts_live_leases(self, tmp_path):
        clk = FakeClock()
        d = str(tmp_path)
        reg = registry.MembershipRegistry(ttl=30, journal_dir=d, clock=clk)
        reg.begin_generation({0: ("worker", 0), 1: ("worker", 1)})
        reg.join(0, "worker", 0)
        reg.join(1, "worker", 1)
        reg.renew(0, beat=5)
        reg.renew(1, beat=7)
        reg.blacklist(9, reason="condemned")
        clk.advance(3)  # well inside the TTL
        reg2 = registry.MembershipRegistry.recover(d, ttl=30, clock=clk)
        assert reg2.epoch == reg.epoch + 1
        assert reg2.live_members() == [0, 1]
        assert reg2.blacklisted() == [9]
        assert reg2.roles() == {0: ("worker", 0), 1: ("worker", 1)}

    def test_recover_restores_target_size_through_compaction(self, tmp_path):
        # every epoch record triggers a manifest compaction that truncates
        # the journal, so the target must survive in the manifest snapshot,
        # not just the journaled epoch record
        clk = FakeClock()
        d = str(tmp_path)
        reg = registry.MembershipRegistry(ttl=30, journal_dir=d, clock=clk)
        reg.begin_generation({0: ("worker", 0)}, target_size=4)
        reg.join(0, "worker", 0)
        reg2 = registry.MembershipRegistry.recover(d, ttl=30, clock=clk)
        assert reg2.target_size == 4
        # ...and a second recovery (reading the fencing manifest the first
        # one committed) still carries it
        reg3 = registry.MembershipRegistry.recover(d, ttl=30, clock=clk)
        assert reg3.target_size == 4

    def test_recover_expires_leases_past_ttl(self, tmp_path):
        clk = FakeClock()
        d = str(tmp_path)
        reg = registry.MembershipRegistry(ttl=10, journal_dir=d, clock=clk)
        reg.begin_generation()
        reg.join(0, "worker", 0)
        reg.renew(0, beat=1)
        clk.advance(60)  # the driver outage outlived the lease
        reg2 = registry.MembershipRegistry.recover(d, ttl=10, clock=clk)
        assert reg2.live_members() == []
        assert reg2.members()[0]["state"] == "expired"

    def test_recovery_fences_stale_writer(self, tmp_path):
        d = str(tmp_path)
        reg = registry.MembershipRegistry(ttl=30, journal_dir=d)
        reg.begin_generation()
        reg.join(0)
        reg2 = registry.MembershipRegistry.recover(d, ttl=30)
        assert reg2.epoch > reg.epoch
        with pytest.raises(registry.StaleEpochError):
            reg.join(1)  # the pre-crash writer must not clobber the journal

    def test_torn_manifest_falls_back_to_previous(self, tmp_path):
        d = str(tmp_path)
        reg = registry.MembershipRegistry(ttl=30, journal_dir=d)
        reg.begin_generation({0: ("worker", 0)})
        reg.join(0, "worker", 0)
        reg2 = registry.MembershipRegistry.recover(d, ttl=30)  # commits a manifest
        mpath = os.path.join(d, registry.MANIFEST_NAME)
        text = open(mpath).read()
        with open(mpath, "w") as f:
            f.write(text[: len(text) // 2])  # tear the newest manifest
        reg3 = registry.MembershipRegistry.recover(d, ttl=30)
        assert reg3.epoch > reg2.epoch
        assert 0 in reg3.members()

    def test_crc_mismatch_detected(self, tmp_path):
        d = str(tmp_path)
        reg = registry.MembershipRegistry(ttl=30, journal_dir=d)
        reg.begin_generation()
        mpath = os.path.join(d, registry.MANIFEST_NAME)
        payload = json.load(open(mpath))
        payload["state"]["epoch"] = 99  # bitrot: valid JSON, wrong content
        with open(mpath, "w") as f:
            json.dump(payload, f)
        loaded, reason = registry._read_manifest_file(mpath)
        assert loaded is None and reason == "checksum mismatch"

    def test_torn_journal_line_stops_replay(self, tmp_path):
        d = str(tmp_path)
        reg = registry.MembershipRegistry(ttl=30, journal_dir=d, manifest_every=1000)
        reg.begin_generation()
        reg.join(0, "worker", 0)
        reg.join(1, "worker", 1)
        jpath = os.path.join(d, registry.JOURNAL_NAME)
        with open(jpath, "a") as f:
            f.write("deadbeef {\"op\": \"join\", \"eid\"")  # crash mid-append
        state = registry._load_state(d)
        # the two whole records replayed; the torn tail was dropped
        assert set(state["members"]) == {"0", "1"}

    def test_journal_lines_are_crc_framed(self, tmp_path):
        d = str(tmp_path)
        reg = registry.MembershipRegistry(ttl=30, journal_dir=d, manifest_every=1000)
        reg.begin_generation()
        reg.join(0)
        for line in open(os.path.join(d, registry.JOURNAL_NAME)):
            crc_hex, _, payload = line.rstrip("\n").partition(" ")
            assert int(crc_hex, 16) == zlib.crc32(payload.encode()) & 0xFFFFFFFF

    def test_renew_journaling_is_coalesced(self, tmp_path):
        """Per-beat renew records would grow the journal without bound; only
        ~one per ttl/4 per member goes to disk."""
        clk = FakeClock()
        d = str(tmp_path)
        reg = registry.MembershipRegistry(
            ttl=40, journal_dir=d, clock=clk, manifest_every=100000
        )
        reg.begin_generation()
        reg.join(0)
        for beat in range(50):
            clk.advance(1)
            reg.renew(0, beat=beat)
        renews = [
            line for line in open(os.path.join(d, registry.JOURNAL_NAME))
            if '"op": "renew"' in line
        ]
        # 50s of beats at ttl/4 = 10s coalescing -> ~5 records, never 50
        assert 1 <= len(renews) <= 10

    def test_manifest_compaction_truncates_journal(self, tmp_path):
        d = str(tmp_path)
        reg = registry.MembershipRegistry(ttl=30, journal_dir=d, manifest_every=3)
        reg.begin_generation()
        for eid in range(6):
            reg.join(eid)
        # compaction ran: journal holds at most manifest_every records
        lines = open(os.path.join(d, registry.JOURNAL_NAME)).read().splitlines()
        assert len(lines) < 6
        reg2 = registry.MembershipRegistry.recover(d, ttl=30)
        assert reg2.live_members() == [0, 1, 2, 3, 4, 5]

    def test_recover_from_empty_dir(self, tmp_path):
        reg = registry.MembershipRegistry.recover(str(tmp_path), ttl=30, fallback_epoch=4)
        assert reg.epoch == 5
        assert reg.live_members() == []

    def test_recover_without_journal_dir(self):
        reg = registry.MembershipRegistry.recover(None, ttl=30, fallback_epoch=2)
        assert reg.epoch == 3


class TestChaosSites:
    def test_journal_tear_leaves_recoverable_state(self, tmp_path):
        """control.journal_tear tears the manifest publish; the journal is
        NOT truncated, so prev-manifest + journal reconstruct everything."""
        d = str(tmp_path)
        reg = registry.MembershipRegistry(ttl=30, journal_dir=d, manifest_every=1000)
        reg.begin_generation({0: ("worker", 0), 1: ("worker", 1)})
        reg.join(0, "worker", 0)
        chaos.install(chaos.ChaosPlan(seed=7).site("control.journal_tear", probability=1.0, max_count=1))
        try:
            reg.join(1, "worker", 1)  # this durable append hits the tear
        finally:
            chaos.uninstall()
        payload, reason = registry._read_manifest_file(
            os.path.join(d, registry.MANIFEST_NAME)
        )
        assert payload is None  # the newest manifest really is torn
        reg2 = registry.MembershipRegistry.recover(d, ttl=30)
        # member 0 survived via prev manifest/journal; member 1's join died
        # with the torn write (crash semantics)
        assert 0 in reg2.members()

    def test_lease_delay_site_is_benign(self):
        chaos.install(
            chaos.ChaosPlan(seed=1).site(
                "control.lease_delay", probability=1.0, max_count=2, delay_s=0.001
            )
        )
        try:
            reg = registry.MembershipRegistry(ttl=30)
            reg.begin_generation()
            reg.join(0)
            assert reg.renew(0, beat=1) is True
            assert reg.live_members() == [0]
        finally:
            chaos.uninstall()


class TestAggregationTree:
    def test_tree_is_sqrt_sized_and_deterministic(self):
        rows = [{"executor_id": i, "manager_addr": ("h", i)} for i in range(9)]
        tree = registry.plan_aggregation_tree(rows)
        assert tree == registry.plan_aggregation_tree(list(reversed(rows)))
        assert len(tree) == 3  # isqrt(9) groups
        covered = sorted(eid for members in tree.values() for eid in members)
        assert covered == list(range(9))
        for agg, members in tree.items():
            assert agg == members[0]  # lowest id of the group aggregates it

    def test_tree_skips_unreachable_rows(self):
        rows = [
            {"executor_id": 0, "manager_addr": ("h", 0)},
            {"executor_id": 1, "manager_addr": None},
        ]
        tree = registry.plan_aggregation_tree(rows)
        assert tree == {0: [0]}

    def test_empty_tree(self):
        assert registry.plan_aggregation_tree([]) == {}

    def test_window_coverage_splits_members(self):
        summary = {
            "window": 7,
            "beats": {"0": 5, "2": 9},
            "status": {"1": "done"},
            "errors": [2],
        }
        statuses, beats, flagged = registry.window_coverage(summary, [0, 1, 2])
        assert statuses == {1: "done"}
        assert beats == {0: 5, 2: 9}
        assert flagged == {2}

    def test_window_coverage_excludes_members_absent_from_summary(self):
        """An executor that died entirely (process/machine gone) appears in
        neither beats, status, nor errors — the aggregator could not reach
        its channel. It must NOT count as covered: if the driver renewed its
        lease anyway (a beat-less renew is unconditional), the dead
        executor's lease would never expire and the failure would never
        surface. Uncovered members fall back to direct polls, where the
        unreachable channel stops renewals."""
        summary = {"window": 3, "beats": {"0": 4}, "status": {}, "errors": []}
        statuses, beats, flagged = registry.window_coverage(summary, [0, 1])
        assert beats == {0: 4}
        assert statuses == {}
        assert flagged == set()
        assert 1 not in statuses and 1 not in beats  # → direct-poll path

    def test_window_coverage_ignores_non_members(self):
        # a summary may carry rows for executors no longer in the tree
        # (stale window from a previous generation): only tree members count
        summary = {"window": 1, "beats": {"0": 1, "9": 8}, "errors": [9]}
        statuses, beats, flagged = registry.window_coverage(summary, [0, 1])
        assert beats == {0: 1}
        assert flagged == set()

    def test_enablement_knob(self, monkeypatch):
        monkeypatch.delenv("TOS_HEARTBEAT_AGG", raising=False)
        assert not registry.aggregation_enabled(1)  # auto: too small
        assert registry.aggregation_enabled(2)
        monkeypatch.setenv("TOS_HEARTBEAT_AGG", "0")
        assert not registry.aggregation_enabled(100)
        monkeypatch.setenv("TOS_HEARTBEAT_AGG", "1")
        assert registry.aggregation_enabled(1)
