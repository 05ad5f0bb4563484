"""Consensus: Fast Paxos fast round + classic Paxos fallback (host oracle).

``Paxos`` mirrors Paxos.java:55-339 — classic single-decree Paxos with the
Fast Paxos coordinator value-selection rule (Lamport tr-2005-112, Fig. 2).
``FastPaxos`` mirrors FastPaxos.java:44-208 — the one-step fast round with
vote counting at quorum N - floor((N-1)/4), plus scheduling of the classic
fallback round after a base delay + expovariate jitter with rate 1/N.

A round is identified by a Rank (round, node_index); the fast round is always
rank (1, 1), and classic rounds start at round 2 with node_index a per-node
integer, so every classic rank orders above the fast round
(Paxos.java:246-260).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from rapid_tpu_torch import hashing
from rapid_tpu_torch.oracle.interfaces import IBroadcaster, IMessagingClient, IScheduler
from rapid_tpu_torch.oracle.membership_view import uid_of
from rapid_tpu_torch.types import (
    Endpoint,
    FastRoundPhase2bMessage,
    Phase1aMessage,
    Phase1bMessage,
    Phase2aMessage,
    Phase2bMessage,
    Rank,
)

Proposal = Tuple[Endpoint, ...]


def classic_rank_node_index(endpoint: Endpoint) -> int:
    """Per-node integer used as the node_index of classic-round ranks.

    The reference uses Java's Endpoint.hashCode() (Paxos.java:102); any fixed
    per-node integer gives the required total order between ranks. We use the
    low 31 bits of the node's 64-bit identity hash.
    """
    return int(hashing.hash64(uid_of(endpoint), seed=0x72616E6B) & 0x7FFFFFFF)


class Paxos:
    """Classic Paxos acceptor+coordinator state for one consensus instance."""

    def __init__(self, my_addr: Endpoint, configuration_id: int, n: int,
                 client: IMessagingClient, broadcaster: IBroadcaster,
                 on_decide: Callable[[List[Endpoint]], None]) -> None:
        self._my_addr = my_addr
        self._configuration_id = configuration_id
        self._n = n
        self._client = client
        self._broadcaster = broadcaster
        self._on_decide = on_decide

        self._rnd = Rank(0, 0)
        self._vrnd = Rank(0, 0)
        self._vval: Proposal = ()
        self._crnd = Rank(0, 0)
        self._cval: Proposal = ()
        # sender -> message (insertion-ordered; deduped per acceptor so a
        # retransmission cannot be double-counted toward the majority)
        self._phase1b_messages: Dict[Endpoint, Phase1bMessage] = {}
        # rank -> {sender -> message}
        self._accept_responses: Dict[Rank, Dict[Endpoint, Phase2bMessage]] = {}
        self._decided = False

    # -- coordinator --------------------------------------------------------

    def start_phase1a(self, round_: int) -> None:
        """Paxos.java:98-111."""
        if self._crnd.round > round_:
            return
        self._crnd = Rank(round_, classic_rank_node_index(self._my_addr))
        self._broadcaster.broadcast(
            Phase1aMessage(self._my_addr, self._configuration_id, self._crnd)
        )

    def handle_phase1a(self, msg: Phase1aMessage) -> None:
        """Acceptor: promise if the rank is new. Paxos.java:118-148."""
        if msg.configuration_id != self._configuration_id:
            return
        if self._rnd < msg.rank:
            self._rnd = msg.rank
        else:
            return
        self._client.send_message(
            msg.sender,
            Phase1bMessage(self._my_addr, self._configuration_id,
                           rnd=self._rnd, vrnd=self._vrnd, vval=self._vval),
        )

    def handle_phase1b(self, msg: Phase1bMessage) -> None:
        """Coordinator: gather promises; past majority, select a value with
        the coordinator rule and broadcast phase2a. Paxos.java:156-188."""
        if msg.configuration_id != self._configuration_id:
            return
        if self._crnd != msg.rnd:
            return
        self._phase1b_messages[msg.sender] = msg
        if len(self._phase1b_messages) > self._n // 2:
            chosen = self.select_proposal_using_coordinator_rule(
                list(self._phase1b_messages.values())
            )
            if not self._cval and chosen:
                self._cval = chosen
                self._broadcaster.broadcast(
                    Phase2aMessage(self._my_addr, self._configuration_id,
                                   rnd=self._crnd, vval=chosen)
                )

    # -- acceptor -----------------------------------------------------------

    def handle_phase2a(self, msg: Phase2aMessage) -> None:
        """Accept and broadcast the vote to everyone. Paxos.java:195-216."""
        if msg.configuration_id != self._configuration_id:
            return
        if self._rnd <= msg.rnd and self._vrnd != msg.rnd:
            self._rnd = msg.rnd
            self._vrnd = msg.rnd
            self._vval = tuple(msg.vval)
            self._broadcaster.broadcast(
                Phase2bMessage(self._my_addr, self._configuration_id,
                               rnd=msg.rnd, endpoints=self._vval)
            )

    def handle_phase2b(self, msg: Phase2bMessage) -> None:
        """Everyone counts phase2b votes per rank; decide past majority.
        Paxos.java:223-238."""
        if msg.configuration_id != self._configuration_id:
            return
        in_rnd = self._accept_responses.setdefault(msg.rnd, {})
        in_rnd[msg.sender] = msg
        if len(in_rnd) > self._n // 2 and not self._decided:
            self._decided = True
            self._on_decide(list(msg.endpoints))

    def register_fast_round_vote(self, vote: Sequence[Endpoint]) -> None:
        """Record our own fast-round vote; rank (1, 1). Paxos.java:246-260."""
        if self._rnd.round > 1:
            return
        self._rnd = Rank(1, 1)
        self._vrnd = self._rnd
        self._vval = tuple(vote)

    # -- value selection ----------------------------------------------------

    def select_proposal_using_coordinator_rule(
            self, phase1b_messages: Sequence[Phase1bMessage]) -> Proposal:
        """Fast Paxos Fig. 2 value-selection rule. Paxos.java:271-328.

        Order-sensitive details preserved from the reference: candidate vvals
        are scanned in message-arrival order, and a value is picked once its
        cumulative occurrence count exceeds N/4 (integer division).
        """
        if not phase1b_messages:
            raise ValueError("phase1b_messages was empty")
        max_vrnd = max(m.vrnd for m in phase1b_messages)

        # V = all vvals voted at the highest vrnd in the quorum.
        collected_vvals: List[Proposal] = [
            tuple(m.vval) for m in phase1b_messages
            if m.vrnd == max_vrnd and len(m.vval) > 0
        ]
        chosen: Optional[Proposal] = None

        if len(set(collected_vvals)) == 1:
            chosen = collected_vvals[0]
        elif len(collected_vvals) > 1:
            counters: Dict[Proposal, int] = {}
            for value in collected_vvals:
                count = counters.setdefault(value, 0)
                if count + 1 > self._n // 4:
                    chosen = value
                    break
                counters[value] = count + 1

        if chosen is None:
            chosen = next(
                (tuple(m.vval) for m in phase1b_messages if len(m.vval) > 0), ()
            )
        return chosen


class FastPaxos:
    """Fast-round consensus wrapper. FastPaxos.java:44-208."""

    def __init__(self, my_addr: Endpoint, configuration_id: int,
                 membership_size: int, client: IMessagingClient,
                 broadcaster: IBroadcaster, scheduler: IScheduler,
                 on_decide: Callable[[List[Endpoint]], None],
                 fallback_base_delay_ticks: int = 10,
                 tick_ms: int = 100, rng=None) -> None:
        self._my_addr = my_addr
        self._configuration_id = configuration_id
        self._n = membership_size
        self._broadcaster = broadcaster
        self._scheduler = scheduler
        self._fallback_base_delay_ticks = fallback_base_delay_ticks
        self._tick_ms = tick_ms
        self._rng = rng
        self._votes_per_proposal: Dict[Proposal, int] = {}
        self._votes_received: set[Endpoint] = set()
        self._decided = False
        self._scheduled_classic_round_task: Optional[object] = None
        self._on_decide_external = on_decide
        self.paxos = Paxos(my_addr, configuration_id, membership_size, client,
                           broadcaster, self._on_decided_wrapped)

    # -- decision funnel ----------------------------------------------------

    def _on_decided_wrapped(self, hosts: List[Endpoint]) -> None:
        """FastPaxos.java:78-85.

        Idempotent: a straggler's classic fallback round can complete after
        the fast round already decided here (the reference has an `assert`
        which is disabled in production Java; a duplicate decision must be
        ignored, not crash or re-fire the view change).
        """
        if self._decided:
            return
        self._decided = True
        if self._scheduled_classic_round_task is not None:
            self._scheduler.cancel(self._scheduled_classic_round_task)
            self._scheduled_classic_round_task = None
        self._on_decide_external(hosts)

    # -- proposer -----------------------------------------------------------

    def propose(self, proposal: Sequence[Endpoint],
                recovery_delay_ticks: Optional[int] = None) -> None:
        """Vote in the fast round and arm the classic-round fallback timer.
        FastPaxos.java:94-117."""
        self.paxos.register_fast_round_vote(tuple(proposal))
        self._broadcaster.broadcast(
            FastRoundPhase2bMessage(self._my_addr, self._configuration_id,
                                    tuple(proposal))
        )
        if recovery_delay_ticks is None:
            recovery_delay_ticks = self.get_random_delay_ticks()
        self._scheduled_classic_round_task = self._scheduler.schedule(
            recovery_delay_ticks, self.start_classic_paxos_round
        )

    def get_random_delay_ticks(self) -> int:
        """Base delay + expovariate jitter with rate 1/N (FastPaxos.java:200-203)."""
        u = self._rng.random() if self._rng is not None else 0.5
        jitter_ms = -1000.0 * math.log(1.0 - u) * self._n
        return self._fallback_base_delay_ticks + max(0, round(jitter_ms / self._tick_ms))

    # -- acceptor -----------------------------------------------------------

    def _handle_fast_round_proposal(self, msg: FastRoundPhase2bMessage) -> None:
        """Count fast-round votes; decide at quorum N - floor((N-1)/4).
        FastPaxos.java:125-156."""
        if msg.configuration_id != self._configuration_id:
            return
        if msg.sender in self._votes_received:
            return
        if self._decided:
            return
        self._votes_received.add(msg.sender)
        proposal = tuple(msg.endpoints)
        count = self._votes_per_proposal.get(proposal, 0) + 1
        self._votes_per_proposal[proposal] = count
        f = (self._n - 1) // 4  # Fast Paxos resiliency
        if len(self._votes_received) >= self._n - f and count >= self._n - f:
            self._on_decided_wrapped(list(msg.endpoints))

    def handle_messages(self, request) -> None:
        """Dispatch consensus messages. FastPaxos.java:163-184."""
        if isinstance(request, FastRoundPhase2bMessage):
            self._handle_fast_round_proposal(request)
        elif isinstance(request, Phase1aMessage):
            self.paxos.handle_phase1a(request)
        elif isinstance(request, Phase1bMessage):
            self.paxos.handle_phase1b(request)
        elif isinstance(request, Phase2aMessage):
            self.paxos.handle_phase2a(request)
        elif isinstance(request, Phase2bMessage):
            self.paxos.handle_phase2b(request)
        else:
            raise TypeError(f"Unexpected message: {type(request)}")

    def start_classic_paxos_round(self) -> None:
        """Fallback entry point (FastPaxos.java:189-195)."""
        if not self._decided:
            self.paxos.start_phase1a(2)
