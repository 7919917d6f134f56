"""Continuous-batching request scheduler: priority + FCFS over decode rows.

Iteration-level scheduling (Orca / vLLM style) without async machinery:
the engine runs one batched step at a time; between steps the scheduler
retires finished sequences and admits waiting requests into freed rows, so
new work joins the running batch mid-stream instead of waiting for a full
batch drain. A "slot" is one *decode row* of a policy group's fixed-shape
step — admission binds a request to a row; its KV memory lives elsewhere,
in the paged block pool (kv_pool.py), so admission is additionally gated by
an optional ``can_admit`` callback (page reservation). The engine runs one
Scheduler per resolved approximation policy: requests batch with their tier
and never force a cross-tier recompile.

Admission is priority-then-FCFS: the highest ``Request.priority`` among
arrived waiters wins each free row (ties resolve in queue order, so equal
priorities reproduce the original FCFS behavior exactly). A preempted
request re-enters the queue at the *front* (``requeue``), so it resumes
before equal-priority newcomers.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Callable, Deque, Dict, List, Optional, Union


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival_step`` lets drivers replay a trace:
    the scheduler will not admit the request before that engine step.

    ``policy`` selects the request's approximation numerics tier: ``None``
    (the engine's base model policy), a tier name registered in
    ``EngineConfig.tiers`` (e.g. ``"free"``), a raw policy spec string
    (``"*/attn/*=exact,*=pc3_tr"``), or an ``ApproxPolicy``. Requests with
    the same *resolved* policy share one step (one policy group each).

    ``priority`` orders admission (higher wins; equal = FCFS) and shields a
    request from preemption: under page exhaustion the engine swaps out the
    lowest-priority running request first."""

    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    arrival_step: int = 0
    policy: Union[None, str, "object"] = None  # name | spec | ApproxPolicy
    priority: int = 0


@dataclasses.dataclass
class RequestState:
    """Scheduler-owned runtime state + accounting for one request."""

    request: Request
    request_id: int = -1  # engine-assigned; the Request is never mutated
    slot: int = -1        # decode row within the policy group
    group: str = ""       # resolved policy-group label (accounting)
    output: List[int] = dataclasses.field(default_factory=list)
    eos_id: Optional[int] = None  # resolved (request or engine default)
    finish_reason: str = ""
    admit_step: int = -1
    finish_step: int = -1
    joined_running_batch: bool = False  # admitted while others were decoding
    # chunked-prefill progress: prompt tokens [0, next_pos) are already in
    # the KV pool (cached_len of them adopted from the prefix cache, the
    # rest written by previous chunks); prefill is done when
    # next_pos == len(prompt) and the first token has been emitted.
    next_pos: int = 0
    cached_len: int = 0
    # wall-clock accounting (seconds, engine-stamped). arrival_time is when
    # the request became admissible — equal to submit_time for immediate
    # arrivals, stamped later for arrival_step-gated trace replays, so
    # TTFT/latency never include simulated pre-arrival queueing.
    # admit_time is the first admission (a resume after a swap keeps it):
    # queue wait is admit - arrival, prefill first_token - admit.
    submit_time: float = 0.0
    arrival_time: float = 0.0
    admit_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0
    prefill_s: float = 0.0  # wall time of the prefill chunks it rode in
    last_token_time: float = 0.0   # stamp of the latest emitted token
    token_gaps_s: List[float] = dataclasses.field(default_factory=list)
    # preemption/swap bookkeeping (engine-owned): ``swap`` holds the
    # host-side K/V snapshot + table length while the request is evicted
    preemptions: int = 0
    swap: Optional[dict] = None
    # speculative-decoding accounting (engine-owned): draft tokens proposed
    # for this request and how many of them the verify step accepted —
    # per-request acceptance feeds the engine's dynamic-k controller
    spec_drafted: int = 0
    spec_accepted: int = 0

    @property
    def ttft_s(self) -> float:
        return self.first_token_time - self.arrival_time

    @property
    def latency_s(self) -> float:
        return self.finish_time - self.arrival_time

    @property
    def seq_len(self) -> int:
        """Logical positions holding real K/V (prefilled + generated)."""
        return self.next_pos + max(0, len(self.output) - 1)

    @property
    def prefilling(self) -> bool:
        return self.slot >= 0 and not self.output


class Scheduler:
    """FCFS continuous-batching scheduler over ``num_slots`` decode rows."""

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self.waiting: Deque[RequestState] = collections.deque()
        self.active: Dict[int, RequestState] = {}   # slot -> state
        self.finished: List[RequestState] = []
        # LIFO pool: a just-retired slot is handed out before older free
        # ones (fresh slots 0..n-1 start in ascending pop order)
        self._free: List[int] = list(range(num_slots))[::-1]
        self._ids = itertools.count()

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def submit(self, request: Request, now: float = 0.0) -> RequestState:
        state = RequestState(request=request, request_id=next(self._ids),
                             eos_id=request.eos_id, submit_time=now,
                             arrival_time=now if request.arrival_step <= 0
                             else 0.0)
        self.waiting.append(state)
        return state

    def admit(self, step: int,
              can_admit: Optional[Callable[[RequestState], bool]] = None
              ) -> List[RequestState]:
        """Bind waiting requests (whose arrival time has come) to free
        rows — highest priority first, FCFS among equals; an unarrived
        request does not block arrived ones queued behind it. ``can_admit``
        gates each admission on external resources (KV page reservation):
        when the chosen candidate is refused, admission stops — strict
        blocking, so a large or high-priority request is not starved by
        smaller ones slipping past it. Returns the newly admitted states;
        the caller must start their prefill before the next decode step."""
        admitted: List[RequestState] = []
        running = bool(self.active)
        while self._free:
            best = -1
            for i, st in enumerate(self.waiting):
                if st.request.arrival_step > step:
                    continue
                if (best < 0 or st.request.priority
                        > self.waiting[best].request.priority):
                    best = i  # strict '>' keeps FCFS order among equals
            if best < 0:
                break
            state = self.waiting[best]
            if can_admit is not None and not can_admit(state):
                break  # blocked on memory: nothing lower slips past
            del self.waiting[best]
            state.slot = self._free.pop()
            state.admit_step = step
            state.joined_running_batch = state.joined_running_batch or running
            self.active[state.slot] = state
            admitted.append(state)
        return admitted

    def requeue(self, slot: int) -> RequestState:
        """Preempt the request in ``slot``: unbind its row and put it back
        at the *front* of the waiting queue (it resumes before any
        equal-priority newcomer). The caller owns KV swap-out/-in."""
        state = self.active.pop(slot)
        state.slot = -1
        state.preemptions += 1
        self._free.append(slot)
        self.waiting.appendleft(state)
        return state

    def retire(self, slot: int, reason: str, step: int,
               now: float = 0.0) -> RequestState:
        """Finish the request in ``slot`` and return the row to the pool."""
        state = self.active.pop(slot)
        state.finish_reason = reason
        state.finish_step = step
        state.finish_time = now
        state.slot = -1
        self._free.append(slot)
        self.finished.append(state)
        return state
