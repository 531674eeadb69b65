"""Raft consensus core (copy of ``bifromq_tpu/raft/node.py``; ≈ reference
base-kv-raft).

Re-expression of the reference's from-scratch raft
(base-kv/base-kv-raft .../raft/RaftNode.java:52 with state classes
RaftNodeStateLeader/Follower/Candidate, PeerLogReplicator, read-index reads,
snapshot install, leader transfer). Deliberately tick-driven like the
reference (RaftNode.tick():99): a host loop calls ``tick()`` at a fixed
cadence and tests drive time manually — no wall-clock coupling.

Scope: leader election (randomized timeouts + pre-vote), log replication
with per-peer next/match index, majority commit, linearizable read-index,
snapshot install for lagging peers with log compaction, leader transfer
(TimeoutNow), single-server config change AND two-phase joint consensus
(C_old,new — ≈ RaftConfigChanger). The port's state is volatile: the
reference's durable hard state/log/snapshot (an IRaftStateStore, so a
restarted node cannot double-vote) arrives with raft/store.py (ROADMAP
A.5b).
"""

from __future__ import annotations

import asyncio
import enum
import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple


class Role(enum.Enum):
    FOLLOWER = "follower"
    CANDIDATE = "candidate"
    LEADER = "leader"


@dataclass
class LogEntry:
    term: int
    index: int
    data: bytes
    # config-change entries carry the new voter set instead of user data;
    # joint-consensus entries additionally carry the outgoing set
    # (C_old,new — ≈ RaftConfigChanger's two-phase change). ``learners``
    # is the NON-VOTING replica set (≈ ClusterConfig.learners): they
    # receive appends/snapshots but never count for quorum or elections.
    config: Optional[Tuple[str, ...]] = None
    config_old: Optional[Tuple[str, ...]] = None
    learners: Optional[Tuple[str, ...]] = None


@dataclass
class Snapshot:
    last_index: int
    last_term: int
    # None: a deferred cut, materialized when a peer needs it
    data: Optional[bytes]
    voters: Tuple[str, ...]
    voters_old: Optional[Tuple[str, ...]] = None
    learners: Tuple[str, ...] = ()


# ------------------------------ messages ------------------------------------

@dataclass
class RequestVote:
    term: int
    candidate: str
    last_log_index: int
    last_log_term: int


@dataclass
class VoteReply:
    term: int
    granted: bool


@dataclass
class PreVote:
    """Pre-vote probe (reference has pre-vote, RaftNode.java):
    asks peers whether a real election at ``term`` could win, WITHOUT
    disturbing terms — prevents partitioned stragglers from inflating their
    term and deposing a healthy leader on heal."""
    term: int   # the term the candidate would campaign at
    candidate: str
    last_log_index: int
    last_log_term: int


@dataclass
class PreVoteReply:
    term: int
    granted: bool


@dataclass
class AppendEntries:
    term: int
    leader: str
    prev_index: int
    prev_term: int
    entries: List[LogEntry]
    leader_commit: int
    read_ctx: Optional[int] = None   # read-index heartbeat correlation


@dataclass
class AppendReply:
    term: int
    success: bool
    match_index: int
    read_ctx: Optional[int] = None


@dataclass
class InstallSnapshot:
    term: int
    leader: str
    snapshot: Snapshot


@dataclass
class SnapshotChunk:
    """One chunk of a snapshot dump session (≈ KVRangeDumpSession
    streaming snapshot KVs to a lagging replica). ``meta`` rides the first
    chunk; ``last`` marks the final one."""
    term: int
    leader: str
    session_id: int
    seq: int
    data: bytes
    last: bool
    meta: Optional[Snapshot] = None   # snapshot WITHOUT data (first chunk)


@dataclass
class SnapshotChunkAck:
    term: int
    session_id: int
    seq: int


@dataclass
class SnapshotReply:
    term: int
    match_index: int


@dataclass
class TimeoutNow:
    term: int


RaftMessage = (RequestVote, VoteReply, AppendEntries, AppendReply,
               InstallSnapshot, SnapshotReply, TimeoutNow)


class ITransport:
    """Fire-and-forget message passing; replies are messages too."""

    def send(self, to: str, sender: str, msg) -> None:
        raise NotImplementedError


class RaftNode:
    """One raft participant hosting an opaque FSM via ``apply_cb``.

    ``apply_cb(entry)`` is invoked exactly once per committed entry in index
    order. ``snapshot_cb()`` must return FSM state bytes;
    ``restore_cb(bytes)`` installs it.
    """

    ELECTION_TICKS = (10, 20)   # randomized range
    HEARTBEAT_TICKS = 2
    MAX_ENTRIES_PER_APPEND = 64
    SNAPSHOT_THRESHOLD = 256    # compact when log grows beyond this
    SNAPSHOT_CHUNK_BYTES = 64 * 1024
    # bandwidth governor (≈ SnapshotBandwidthGovernor): bytes of snapshot
    # chunks a leader may ship per tick, across all dump sessions
    SNAPSHOT_BYTES_PER_TICK = 256 * 1024

    def __init__(self, node_id: str, voters: List[str],
                 transport: ITransport, *,
                 learners: Optional[List[str]] = None,
                 apply_cb: Callable[[LogEntry], None],
                 snapshot_cb: Callable[[], bytes] = lambda: b"",
                 restore_cb: Callable[[bytes], None] = lambda b: None,
                 rng: Optional[random.Random] = None) -> None:
        self.id = node_id
        self.voters: Set[str] = set(voters)
        # outgoing voter set while a joint config (C_old,new) is in flight
        self.voters_old: Optional[Set[str]] = None
        # non-voting replicas (≈ ClusterConfig.learners): replicated to,
        # never counted for quorum, never campaign
        self.learners: Set[str] = set(learners or [])
        self.transport = transport
        self.apply_cb = apply_cb
        self.snapshot_cb = snapshot_cb
        self.restore_cb = restore_cb
        self.rng = rng or random.Random(hash(node_id) & 0xFFFF)

        self.role = Role.FOLLOWER
        self.term = 0
        self.voted_for: Optional[str] = None
        self.leader_id: Optional[str] = None
        # log[0] is a sentinel for (snap_index, snap_term)
        self.snap = Snapshot(last_index=0, last_term=0, data=b"",
                             voters=tuple(voters),
                             learners=tuple(sorted(self.learners)))
        self.log: List[LogEntry] = []
        self.commit_index = 0
        self.last_applied = 0

        self._votes: Set[str] = set()
        self._next_index: Dict[str, int] = {}
        self._match_index: Dict[str, int] = {}
        self._election_elapsed = 0
        self._heartbeat_elapsed = 0
        self._election_deadline = self._rand_election()
        self._propose_waiters: Dict[int, asyncio.Future] = {}
        self._config_final_fut: Optional[asyncio.Future] = None
        # index of the in-flight joint (C_old,new) entry; phase 2 must not
        # start until commit_index covers it
        self._joint_index: Optional[int] = None
        self._read_waiters: Dict[int, Tuple[asyncio.Future, Set[str], int]] = {}
        self._read_ctx_seq = 0
        self._term_start_index = 0  # index of this term's no-op (leader)
        self._transfer_target: Optional[str] = None
        # leader-side dump sessions: peer -> {id, snap, offset, inflight}
        self._dump_sessions: Dict[str, dict] = {}
        self._dump_session_seq = 0
        # the snapshot dump sessions ship while self.snap is a deferred cut
        self._shipped_snap: Optional[Snapshot] = None
        self._dump_budget = 0       # governor tokens (bytes), refilled per tick
        # follower-side restore session: {id, leader, meta, chunks: {seq: b}}
        self._restore_session: Optional[dict] = None
        self.stopped = False

    # ---------------- log helpers ------------------------------------------

    def _rand_election(self) -> int:
        return self.rng.randint(*self.ELECTION_TICKS)

    def _replication_targets(self) -> Set[str]:
        return self._all_voters() | self.learners

    def _all_voters(self) -> Set[str]:
        return (self.voters | self.voters_old if self.voters_old is not None
                else self.voters)

    def _quorum(self, acks: Set[str]) -> bool:
        """Majority — in BOTH configs while a joint change is in flight."""
        ok = len(acks & self.voters) * 2 > len(self.voters)
        if self.voters_old is not None:
            ok = ok and (len(acks & self.voters_old) * 2
                         > len(self.voters_old))
        return ok

    @property
    def last_index(self) -> int:
        return self.log[-1].index if self.log else self.snap.last_index

    @property
    def last_term(self) -> int:
        return self.log[-1].term if self.log else self.snap.last_term

    def _entry(self, index: int) -> Optional[LogEntry]:
        if index <= self.snap.last_index or index > self.last_index:
            return None
        return self.log[index - self.snap.last_index - 1]

    def _term_at(self, index: int) -> Optional[int]:
        if index == self.snap.last_index:
            return self.snap.last_term
        e = self._entry(index)
        return e.term if e else None

    def _entries_from(self, index: int) -> List[LogEntry]:
        if index <= self.snap.last_index:
            return []
        return self.log[index - self.snap.last_index - 1:]

    # ---------------- public API -------------------------------------------

    def tick(self) -> None:
        """Advance logical time by one tick (≈ RaftNode.tick():99)."""
        if self.stopped:
            return
        if self.role == Role.LEADER:
            self._heartbeat_elapsed += 1
            if self._heartbeat_elapsed >= self.HEARTBEAT_TICKS:
                self._heartbeat_elapsed = 0
                self._broadcast_append()
            self._dump_budget = min(self.SNAPSHOT_BYTES_PER_TICK * 4,
                                    self._dump_budget
                                    + self.SNAPSHOT_BYTES_PER_TICK)
            self._pump_dump_sessions(tick=True)
        else:
            self._election_elapsed += 1
            if self._election_elapsed >= self._election_deadline:
                self._start_prevote()

    def propose(self, data: bytes) -> "asyncio.Future[int]":
        """Append a command; resolves with its index once committed.

        Rejected immediately when not leader (caller retries via the
        leader hint), matching the reference's leader-only propose.
        """
        fut = asyncio.get_running_loop().create_future()
        if self.role != Role.LEADER:
            fut.set_exception(NotLeaderError(self.leader_id))
            return fut
        entry = LogEntry(term=self.term, index=self.last_index + 1, data=data)
        self.log.append(entry)
        self._propose_waiters[entry.index] = fut
        self._match_index[self.id] = self.last_index
        self._broadcast_append()
        self._maybe_commit()
        return fut

    def read_index(self) -> "asyncio.Future[int]":
        """Linearizable read barrier (≈ RaftNode.readIndex():141): resolves
        with a commit index safe to serve reads at, after a heartbeat round
        confirms leadership."""
        fut = asyncio.get_running_loop().create_future()
        if self.role != Role.LEADER:
            fut.set_exception(NotLeaderError(self.leader_id))
            return fut
        if (len(self.voters) == 1 and self.voters_old is None
                and self.commit_index >= self._term_start_index):
            fut.set_result(self.commit_index)
            return fut
        self._read_ctx_seq += 1
        ctx = self._read_ctx_seq
        self._read_waiters[ctx] = (fut, {self.id}, self.commit_index)
        self._broadcast_append(read_ctx=ctx)
        return fut

    def change_config(self, new_voters: List[str],
                      new_learners: Optional[List[str]] = None
                      ) -> "asyncio.Future[int]":
        """Cluster membership change (≈ RaftNode.changeClusterConfig():206).

        A one-voter delta commits as a single config entry (raft
        single-server change). Anything larger runs two-phase joint
        consensus (≈ RaftConfigChanger): first a C_old,new entry requiring
        majorities in BOTH sets, then — once that commits — the final C_new
        entry. The returned future resolves when the FINAL config commits.

        ``new_learners`` (None = keep current) replaces the non-voting
        set; learner changes never affect quorum so they always ride the
        entry directly (promotion learner→voter counts as a one-voter
        delta).
        """
        fut = asyncio.get_running_loop().create_future()
        if self.role != Role.LEADER:
            fut.set_exception(NotLeaderError(self.leader_id))
            return fut
        if self.voters_old is not None:
            fut.set_exception(RuntimeError("config change in progress"))
            return fut
        target = tuple(sorted(new_voters))
        learner_target = tuple(sorted(
            set(self.learners if new_learners is None else new_learners)
            - set(new_voters)))
        diff = self.voters.symmetric_difference(new_voters)
        if len(diff) <= 1:
            entry = LogEntry(term=self.term, index=self.last_index + 1,
                             data=b"", config=target,
                             learners=learner_target)
            self._propose_waiters[entry.index] = fut
        else:
            entry = LogEntry(term=self.term, index=self.last_index + 1,
                             data=b"", config=target,
                             config_old=tuple(sorted(self.voters)),
                             learners=learner_target)
            # resolved when the final (C_new-only) entry commits
            self._config_final_fut = fut
        before = self._replication_targets()
        self.log.append(entry)
        # a config entry takes effect as soon as it is appended
        self._set_config(entry.config, entry.config_old, entry.learners)
        if entry.config_old is not None:
            self._joint_index = entry.index
        self._match_index[self.id] = self.last_index
        self._broadcast_append()
        # ship the config entry to members it removes too: appending it is
        # how they learn they're out (→ zombie-quit at their store); in the
        # joint path removed peers are still in _all_voters() and the
        # broadcast above already reached them
        for peer in before - self._replication_targets() - {self.id}:
            self._send_append(peer)
        self._maybe_commit()
        return fut

    def recover(self, live_voters: Optional[List[str]] = None) -> None:
        """Quorum-loss recovery (≈ KVRangeFSM.recover:512 serving the
        RecoverRequest RPC, BaseKVStoreService.proto:33): force-adopt a
        voter config containing only known-reachable members so a range
        that lost its majority can elect and serve again.

        UNSAFE by design if the 'lost' replicas are actually alive across a
        partition (two sides could fork history) — operator/controller
        invoked only, exactly like the reference's recover API.
        """
        new = set(live_voters) if live_voters else {self.id}
        if self.id not in new:
            raise ValueError("recover() must include this member")
        # an in-flight change is superseded — its caller must not observe
        # success when the recover entry later commits
        if self._config_final_fut is not None:
            if not self._config_final_fut.done():
                self._config_final_fut.set_exception(
                    RuntimeError("config change superseded by recover()"))
            self._config_final_fut = None
        entry = LogEntry(term=self.term, index=self.last_index + 1,
                         data=b"", config=tuple(sorted(new)), learners=())
        self.log.append(entry)
        self._set_config(entry.config, None, ())
        self._joint_index = None
        # campaign immediately: with the forced config this member can win
        self._start_election()

    @property
    def is_zombie(self) -> bool:
        """True once a config that excludes this member took effect — the
        hosting store retires such replicas (≈ the reference's zombie-quit:
        a replica outside the latest config destroys itself)."""
        return self.id not in self._replication_targets()

    def transfer_leadership(self, target: str) -> None:
        """(≈ RaftNode.transferLeadership():171)"""
        if self.role != Role.LEADER or target not in self.voters:
            return
        self._transfer_target = target
        if self._match_index.get(target, 0) == self.last_index:
            self.transport.send(target, self.id, TimeoutNow(term=self.term))
        # else: replication catch-up will trigger it from _on_append_reply

    def stop(self) -> None:
        self.stopped = True

    # ---------------- message handling -------------------------------------

    def receive(self, sender: str, msg) -> None:
        if self.stopped:
            return
        # pre-vote traffic must not disturb terms
        if isinstance(msg, PreVote):
            self._on_pre_vote(sender, msg)
            return
        if isinstance(msg, PreVoteReply):
            self._on_pre_vote_reply(sender, msg)
            return
        term = getattr(msg, "term", None)
        if term is not None and term > self.term:
            self._become_follower(term, None)
        if isinstance(msg, RequestVote):
            self._on_request_vote(sender, msg)
        elif isinstance(msg, VoteReply):
            self._on_vote_reply(sender, msg)
        elif isinstance(msg, AppendEntries):
            self._on_append(sender, msg)
        elif isinstance(msg, AppendReply):
            self._on_append_reply(sender, msg)
        elif isinstance(msg, InstallSnapshot):
            self._on_install_snapshot(sender, msg)
        elif isinstance(msg, SnapshotChunk):
            self._on_snapshot_chunk(sender, msg)
        elif isinstance(msg, SnapshotChunkAck):
            self._on_snapshot_chunk_ack(sender, msg)
        elif isinstance(msg, SnapshotReply):
            self._on_snapshot_reply(sender, msg)
        elif isinstance(msg, TimeoutNow):
            if msg.term == self.term and self.id in self.voters:
                self._start_election()

    # ---------------- elections --------------------------------------------

    def _become_follower(self, term: int, leader: Optional[str]) -> None:
        if term > self.term:
            self.term = term
            self.voted_for = None
        prev_role = self.role
        self.role = Role.FOLLOWER
        self.leader_id = leader
        self._election_elapsed = 0
        self._election_deadline = self._rand_election()
        if prev_role == Role.LEADER:
            self._fail_waiters()
            self._dump_sessions.clear()

    def _start_prevote(self) -> None:
        """Probe electability before burning a term (pre-vote)."""
        if self.id not in self._all_voters():
            return
        self._election_elapsed = 0
        self._election_deadline = self._rand_election()
        self._prevotes = {self.id}
        if self._quorum(self._prevotes):
            self._start_election()
            return
        for peer in self._all_voters() - {self.id}:
            self.transport.send(peer, self.id, PreVote(
                term=self.term + 1, candidate=self.id,
                last_log_index=self.last_index, last_log_term=self.last_term))

    def _on_pre_vote(self, sender: str, msg: PreVote) -> None:
        up_to_date = (msg.last_log_term, msg.last_log_index) >= (
            self.last_term, self.last_index)
        # leader stickiness: only grant if we haven't heard from a live
        # leader recently (or never knew one)
        no_recent_leader = (self.leader_id is None
                            or self._election_elapsed
                            >= self.ELECTION_TICKS[0])
        granted = (msg.term >= self.term and up_to_date and no_recent_leader
                   and self.role != Role.LEADER)
        self.transport.send(sender, self.id,
                            PreVoteReply(term=self.term, granted=granted))

    def _on_pre_vote_reply(self, sender: str, msg: PreVoteReply) -> None:
        if self.role == Role.LEADER or not hasattr(self, "_prevotes"):
            return
        if msg.granted:
            self._prevotes.add(sender)
            if self._quorum(self._prevotes):
                self._prevotes = set()
                self._start_election()

    def _start_election(self) -> None:
        if self.id not in self._all_voters():
            return
        self.role = Role.CANDIDATE
        self.term += 1
        self.voted_for = self.id
        self.leader_id = None
        self._votes = {self.id}
        self._election_elapsed = 0
        self._election_deadline = self._rand_election()
        for peer in self._all_voters() - {self.id}:
            self.transport.send(peer, self.id, RequestVote(
                term=self.term, candidate=self.id,
                last_log_index=self.last_index, last_log_term=self.last_term))
        self._check_majority_votes()

    def _on_request_vote(self, sender: str, msg: RequestVote) -> None:
        granted = False
        if msg.term >= self.term:
            up_to_date = (msg.last_log_term, msg.last_log_index) >= (
                self.last_term, self.last_index)
            if up_to_date and self.voted_for in (None, msg.candidate):
                granted = True
                self.voted_for = msg.candidate
                self._election_elapsed = 0
        self.transport.send(sender, self.id,
                            VoteReply(term=self.term, granted=granted))

    def _on_vote_reply(self, sender: str, msg: VoteReply) -> None:
        if self.role != Role.CANDIDATE or msg.term != self.term:
            return
        if msg.granted:
            self._votes.add(sender)
            self._check_majority_votes()

    def _check_majority_votes(self) -> None:
        if self._quorum(self._votes):
            self._become_leader()

    def _become_leader(self) -> None:
        self.role = Role.LEADER
        self.leader_id = self.id
        self._transfer_target = None
        self._heartbeat_elapsed = 0
        peers = self._replication_targets()
        self._next_index = {p: self.last_index + 1 for p in peers}
        self._match_index = {p: 0 for p in peers}
        self._match_index[self.id] = self.last_index
        # no-op entry to commit prior-term entries promptly; read-index is
        # gated on it committing (raft §8: a new leader may not serve
        # linearizable reads until it has committed an entry in its term)
        noop = LogEntry(term=self.term, index=self.last_index + 1, data=b"")
        self.log.append(noop)
        self._term_start_index = self.last_index
        self._match_index[self.id] = self.last_index
        # NOTE: if a joint config is in flight (voters_old set), the final
        # C_new entry is appended only AFTER this term's no-op commits under
        # the JOINT quorum (see _apply_committed) — appending it here would
        # let an uncommitted joint config decide commits, splitting brains
        self._broadcast_append()
        self._maybe_commit()  # single-voter groups commit immediately

    # ---------------- replication ------------------------------------------

    def _broadcast_append(self, read_ctx: Optional[int] = None) -> None:
        for peer in self._replication_targets() - {self.id}:
            self._send_append(peer, read_ctx=read_ctx)

    def _send_append(self, peer: str,
                     read_ctx: Optional[int] = None) -> None:
        nxt = self._next_index.get(peer, self.last_index + 1)
        if nxt <= self.snap.last_index:
            # ship the materialized snapshot via a chunked dump session
            # (its data is serialized at its cut, so it is consistent with
            # its last_index label)
            self._start_dump_session(peer)
            return
        prev_index = nxt - 1
        prev_term = self._term_at(prev_index)
        if prev_term is None:
            prev_index = self.snap.last_index
            prev_term = self.snap.last_term
        entries = self._entries_from(nxt)[:self.MAX_ENTRIES_PER_APPEND]
        self.transport.send(peer, self.id, AppendEntries(
            term=self.term, leader=self.id, prev_index=prev_index,
            prev_term=prev_term, entries=list(entries),
            leader_commit=self.commit_index, read_ctx=read_ctx))

    def _on_append(self, sender: str, msg: AppendEntries) -> None:
        if msg.term < self.term:
            self.transport.send(sender, self.id, AppendReply(
                term=self.term, success=False, match_index=0,
                read_ctx=msg.read_ctx))
            return
        self._become_follower(msg.term, msg.leader)
        local_prev_term = self._term_at(msg.prev_index)
        if local_prev_term is None or local_prev_term != msg.prev_term:
            self.transport.send(sender, self.id, AppendReply(
                term=self.term, success=False,
                match_index=self.snap.last_index, read_ctx=msg.read_ctx))
            return
        appended: List[LogEntry] = []
        for e in msg.entries:
            existing = self._term_at(e.index)
            if existing is None or existing != e.term:
                # truncate conflicting suffix, then append
                self.log = self.log[:max(0, e.index - self.snap.last_index - 1)]
                self.log.append(e)
                appended.append(e)
        if appended:
            # a truncation may have dropped an uncommitted config entry;
            # recompute the voter sets from snapshot + surviving log so no
            # phantom config lingers
            self._recompute_config()
        match = msg.prev_index + len(msg.entries)
        if msg.leader_commit > self.commit_index:
            self.commit_index = min(msg.leader_commit, self.last_index)
            self._apply_committed()
        self.transport.send(sender, self.id, AppendReply(
            term=self.term, success=True, match_index=match,
            read_ctx=msg.read_ctx))

    def _on_append_reply(self, sender: str, msg: AppendReply) -> None:
        if self.role != Role.LEADER or msg.term != self.term:
            return
        if msg.success:
            self._match_index[sender] = max(
                self._match_index.get(sender, 0), msg.match_index)
            self._next_index[sender] = self._match_index[sender] + 1
            self._maybe_commit()
            if msg.read_ctx is not None:
                self._ack_read(sender, msg.read_ctx)
            if (self._transfer_target == sender
                    and self._match_index[sender] == self.last_index):
                self.transport.send(sender, self.id,
                                    TimeoutNow(term=self.term))
            elif self._match_index[sender] < self.last_index:
                self._send_append(sender)
        else:
            # back off; fast-rewind to the follower's snapshot boundary hint
            hint = msg.match_index + 1
            self._next_index[sender] = min(
                hint, max(1, self._next_index.get(sender, 1) - 1))
            self._send_append(sender)

    def _maybe_commit(self) -> None:
        if self.role != Role.LEADER:
            return
        for idx in range(self.last_index, self.commit_index, -1):
            t = self._term_at(idx)
            if t != self.term:
                continue  # only commit current-term entries by counting
            acks = {p for p in self._all_voters()
                    if self._match_index.get(p, 0) >= idx}
            if self._quorum(acks):
                self.commit_index = idx
                self._apply_committed()
                break

    def _apply_committed(self) -> None:
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            e = self._entry(self.last_applied)
            if e is not None and e.config is None and e.data:
                self.apply_cb(e)
            fut = self._propose_waiters.pop(self.last_applied, None)
            if fut is not None and not fut.done():
                fut.set_result(self.last_applied)
            if e is not None and e.config is not None \
                    and e.config_old is None:
                if self._config_final_fut is not None \
                        and not self._config_final_fut.done():
                    self._config_final_fut.set_result(self.last_applied)
                    self._config_final_fut = None
                if (self.role == Role.LEADER
                        and self.id not in self.voters):
                    # a leader removed by the committed final config
                    # steps down
                    self._become_follower(self.term, None)
        if (self.role == Role.LEADER
                and self.commit_index >= self._term_start_index):
            if (self.voters_old is not None
                    and self.commit_index >= (self._joint_index or 0)):
                # the joint entry itself is committed under BOTH quorums:
                # safe to leave the joint config now — exactly once, since
                # this flips voters_old to None
                self._append_final_config()
            self._flush_confirmed_reads()
        self._maybe_compact()

    def _flush_confirmed_reads(self) -> None:
        """Resolve read waiters whose quorum arrived before the term-start
        no-op committed (read-index gating)."""
        for ctx in list(self._read_waiters):
            fut, acks, _ = self._read_waiters[ctx]
            if self._quorum(acks):
                del self._read_waiters[ctx]
                if not fut.done():
                    fut.set_result(self.commit_index)

    # ---------------- read index -------------------------------------------

    def _ack_read(self, sender: str, ctx: int) -> None:
        st = self._read_waiters.get(ctx)
        if st is None:
            return
        fut, acks, _ = st
        acks.add(sender)
        if self._quorum(acks) and self.commit_index >= self._term_start_index:
            # leadership confirmed AND this term has a committed entry:
            # the current commit index is a safe linearization point
            del self._read_waiters[ctx]
            if not fut.done():
                fut.set_result(self.commit_index)
        # else: keep waiting; _apply_committed re-checks once the no-op lands

    # ---------------- snapshots --------------------------------------------

    def _maybe_compact(self) -> None:
        """Drop the applied log past the threshold. Unlike the reference,
        the cut defers its data: serializing the whole state machine every
        ``SNAPSHOT_THRESHOLD`` entries costs a range that grows by one key
        an entry time quadratic in its size (a million retained topics
        would take hours), so the state is serialized only when a peer
        needs it (:meth:`_materialized_snap`)."""
        if len(self.log) <= self.SNAPSHOT_THRESHOLD:
            return
        # the snapshot MUST be cut exactly at last_applied: snapshot_cb()
        # serializes FSM state as applied through last_applied, and labeling
        # it lower would make followers re-apply covered entries
        cut = self.last_applied
        if cut <= self.snap.last_index:
            return
        term = self._term_at(cut)
        if term is None:
            return
        # slice with the OLD snapshot offset before replacing it
        new_log = self._entries_from(cut + 1)
        self.snap = Snapshot(last_index=cut, last_term=term, data=None,
                             **self._snap_config())
        self.log = new_log

    def _snap_config(self) -> dict:
        return dict(voters=tuple(sorted(self.voters)),
                    voters_old=(tuple(sorted(self.voters_old))
                                if self.voters_old is not None else None),
                    learners=tuple(sorted(self.learners)))

    def _materialized_snap(self) -> Snapshot:
        """The snapshot a dump session ships. A deferred cut stays the
        log's offset, as the reference's cut would be; the shipped
        snapshot is cut at last_applied, where its data is serialized
        now, and the log keeps every entry past the deferred cut, so a
        peer only a few entries behind still catches up from the log. It
        is reused until a later cut passes it."""
        if self.snap.data is not None:
            return self.snap
        shipped = self._shipped_snap
        if shipped is None or shipped.last_index < self.snap.last_index:
            cut = self.last_applied
            shipped = self._shipped_snap = Snapshot(
                last_index=cut, last_term=self._term_at(cut),
                data=self.snapshot_cb(), **self._snap_config())
        return shipped

    # ----- chunked dump sessions (≈ KVRangeDumpSession / KVRangeRestorer) --

    def _start_dump_session(self, peer: str) -> None:
        snap = self._materialized_snap()
        sess = self._dump_sessions.get(peer)
        if sess is not None and sess["snap"] is snap:
            return  # already streaming this snapshot
        self._dump_session_seq += 1
        self._dump_sessions[peer] = {
            "id": self._dump_session_seq,
            "snap": snap,
            "offset": 0,
            "awaiting_ack": None,   # seq in flight, stop-and-wait
            "next_seq": 0,
        }

    DUMP_ACK_TIMEOUT_TICKS = 20

    def _pump_dump_sessions(self, tick: bool = False) -> None:
        """Ship chunks within the governor's byte budget; a chunk unacked
        for DUMP_ACK_TIMEOUT_TICKS restarts the session (chunks can be lost
        while the peer is still partitioned). ``age`` counts TICKS only —
        ack-triggered pumps must not age other peers' sessions."""
        for peer, sess in list(self._dump_sessions.items()):
            if sess["awaiting_ack"] is not None:
                if tick:
                    sess["age"] = sess.get("age", 0) + 1
                if sess.get("age", 0) >= self.DUMP_ACK_TIMEOUT_TICKS:
                    self._dump_session_seq += 1
                    sess.update(id=self._dump_session_seq, offset=0,
                                awaiting_ack=None, next_seq=0, age=0)
                else:
                    continue
            if self._dump_budget < self.SNAPSHOT_CHUNK_BYTES \
                    and sess["offset"] > 0:
                continue  # out of budget this tick
            snap: Snapshot = sess["snap"]
            data = snap.data
            off = sess["offset"]
            chunk = data[off:off + self.SNAPSHOT_CHUNK_BYTES]
            last = off + len(chunk) >= len(data)
            meta = None
            if sess["next_seq"] == 0:
                meta = Snapshot(last_index=snap.last_index,
                                last_term=snap.last_term, data=b"",
                                voters=snap.voters,
                                voters_old=snap.voters_old,
                                learners=snap.learners)
            self.transport.send(peer, self.id, SnapshotChunk(
                term=self.term, leader=self.id, session_id=sess["id"],
                seq=sess["next_seq"], data=chunk, last=last, meta=meta))
            self._dump_budget -= len(chunk)
            sess["awaiting_ack"] = sess["next_seq"]
            sess["age"] = 0
            sess["next_seq"] += 1
            sess["offset"] = off + len(chunk)

    def _on_snapshot_chunk_ack(self, sender: str,
                               msg: SnapshotChunkAck) -> None:
        if self.role != Role.LEADER or msg.term != self.term:
            return
        sess = self._dump_sessions.get(sender)
        if sess is None or sess["id"] != msg.session_id:
            return
        if sess["awaiting_ack"] == msg.seq:
            sess["awaiting_ack"] = None
            if sess["offset"] >= len(sess["snap"].data):
                del self._dump_sessions[sender]  # done; reply advances peer
            else:
                self._pump_dump_sessions()

    def _on_snapshot_chunk(self, sender: str, msg: SnapshotChunk) -> None:
        if msg.term < self.term:
            return
        self._become_follower(msg.term, msg.leader)
        rs = self._restore_session
        if msg.seq == 0:
            rs = self._restore_session = {
                "id": msg.session_id, "leader": msg.leader,
                "meta": msg.meta, "chunks": [],
            }
        if rs is None or rs["id"] != msg.session_id \
                or msg.seq != len(rs["chunks"]):
            # stale/out-of-order session: drop (leader restarts a session)
            self._restore_session = None
            return
        rs["chunks"].append(msg.data)
        self.transport.send(sender, self.id, SnapshotChunkAck(
            term=self.term, session_id=msg.session_id, seq=msg.seq))
        if msg.last:
            meta: Snapshot = rs["meta"]
            self._restore_session = None
            snap = Snapshot(last_index=meta.last_index,
                            last_term=meta.last_term,
                            data=b"".join(rs["chunks"]),
                            voters=meta.voters,
                            voters_old=meta.voters_old,
                            learners=meta.learners)
            self._install_snapshot_obj(sender, snap)

    def _install_snapshot_obj(self, sender: str, snapshot: Snapshot) -> None:
        if snapshot.last_index <= self.commit_index:
            self.transport.send(sender, self.id, SnapshotReply(
                term=self.term, match_index=self.commit_index))
            return
        self.snap = snapshot
        self._shipped_snap = None
        self.log = []
        self.commit_index = snapshot.last_index
        self.last_applied = snapshot.last_index
        self.voters = set(snapshot.voters)
        self.voters_old = (set(snapshot.voters_old)
                           if snapshot.voters_old is not None else None)
        self.learners = set(snapshot.learners)
        self._joint_index = (snapshot.last_index
                             if self.voters_old is not None else None)
        self.restore_cb(snapshot.data)
        self.transport.send(sender, self.id, SnapshotReply(
            term=self.term, match_index=snapshot.last_index))

    def _on_install_snapshot(self, sender: str, msg: InstallSnapshot) -> None:
        """Legacy single-message install (in-proc tests); live transfers
        go through the chunked dump session path."""
        if msg.term < self.term:
            return
        self._become_follower(msg.term, msg.leader)
        self._install_snapshot_obj(sender, msg.snapshot)

    def _on_snapshot_reply(self, sender: str, msg: SnapshotReply) -> None:
        if self.role != Role.LEADER or msg.term != self.term:
            return
        self._match_index[sender] = max(self._match_index.get(sender, 0),
                                        msg.match_index)
        self._next_index[sender] = self._match_index[sender] + 1
        self._send_append(sender)

    # ---------------- config -----------------------------------------------

    def _recompute_config(self) -> None:
        """Derive the effective voter sets from snapshot + log (the last
        config entry wins) — used after load and after conflict truncation."""
        voters: Tuple[str, ...] = tuple(self.snap.voters)
        old = self.snap.voters_old
        learners: Tuple[str, ...] = tuple(self.snap.learners)
        ji = self.snap.last_index if old is not None else None
        for e in self.log:
            if e.config is not None:
                voters, old = e.config, e.config_old
                if e.learners is not None:
                    learners = e.learners
                ji = e.index if e.config_old is not None else None
        self._set_config(voters, old, learners)
        self._joint_index = ji

    def _set_config(self, voters: Tuple[str, ...],
                    voters_old: Optional[Tuple[str, ...]] = None,
                    learners: Optional[Tuple[str, ...]] = None) -> None:
        self.voters = set(voters)
        self.voters_old = set(voters_old) if voters_old is not None else None
        if learners is not None:
            self.learners = set(learners) - self.voters
        if self.role == Role.LEADER:
            for p in self._replication_targets():
                self._next_index.setdefault(p, self.last_index + 1)
                self._match_index.setdefault(p, 0)

    def _append_final_config(self) -> None:
        """Phase 2 of joint consensus: leave the joint config."""
        removed = self._all_voters() - self.voters
        entry = LogEntry(term=self.term, index=self.last_index + 1, data=b"",
                         config=tuple(sorted(self.voters)),
                         learners=tuple(sorted(self.learners)))
        self.log.append(entry)
        self._set_config(entry.config, None)
        self._joint_index = None
        if self._config_final_fut is not None:
            self._propose_waiters[entry.index] = self._config_final_fut
            self._config_final_fut = None
        self._match_index[self.id] = self.last_index
        self._broadcast_append()
        for peer in removed - {self.id}:   # outgoing members learn they're
            self._send_append(peer)        # out (zombie-quit trigger)
        self._maybe_commit()  # a sole surviving voter commits immediately

    def _fail_waiters(self) -> None:
        for fut in self._propose_waiters.values():
            if not fut.done():
                fut.set_exception(NotLeaderError(self.leader_id))
        self._propose_waiters.clear()
        if self._config_final_fut is not None:
            if not self._config_final_fut.done():
                self._config_final_fut.set_exception(
                    NotLeaderError(self.leader_id))
            self._config_final_fut = None
        for fut, _, _ in self._read_waiters.values():
            if not fut.done():
                fut.set_exception(NotLeaderError(self.leader_id))
        self._read_waiters.clear()


class NotLeaderError(Exception):
    def __init__(self, leader_hint: Optional[str]) -> None:
        super().__init__(f"not leader (hint: {leader_hint})")
        self.leader_hint = leader_hint
