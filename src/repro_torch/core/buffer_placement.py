"""Algorithm 1 — AIE buffer address placement, plus a bank-conflict model.

The AIE2 local memory is 64 KB in 4 banks of 16 KB.  Six buffers must be
placed: ping/pong for each of A, B (inputs) and C (output).  The paper's
placement rules (Section IV-A):

  (a) never assign ping and pong of the same matrix to the same bank;
  (b) never assign ping and pong of the same matrix to *adjacent* banks;
  (c) always assign A and B buffers to different banks.

Rules (a)/(b) exist because the DMA fills the pong buffer while the core
reads the ping buffer (and vice versa): if those live on the same bank every
cycle collides.  Rule (c) avoids the two concurrent input streams colliding.

Algorithm 1 (faithfully implemented in :func:`place_buffers`): A/B buffers
are only placed into banks with both spots free whose *adjacent* banks do
not hold the buffer's double; C buffers are placed first-fit as a second
occupant, and when a bank overflows, subsequent start addresses shift by the
overflow offset (lines 27-29).

:func:`simulate_stalls` is our stall model: a cycle-stepped simulation of
the six concurrent memory agents (core loads A/B, core stores C, DMA fills
A/B, DMA drains C) counting same-cycle same-bank collisions.  The absolute
stall->cycle scale is calibrated per precision in :mod:`repro_torch.core.aiesim`;
tests assert the paper's *relative* claims (custom address placement
recovers ~12pp KCE over location placement).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import hw
from repro_torch.core.gemm_model import GemmShape, memory_bytes

# Placement strategies evaluated in Table III.
UNCONSTRAINED = "unconstrained"          # BufferOptLevel 9, may spill off-AIE
LOCATION = "location_placement"          # constrained to AIE, compiler packs
ADDRESS = "address_placement"            # constrained to AIE, Algorithm 1


@dataclasses.dataclass
class Buffer:
    name: str          # e.g. "ping_A"
    matrix: str        # "A" | "B" | "C"
    phase: str         # "ping" | "pong"
    size: int
    start_addr: Optional[int] = None
    # Bank chosen by Algorithm 1's phase 1.  The paper's rules (a)-(c)
    # constrain this assignment; the phase-2 overflow shift (lines 27-29)
    # may move the buffer's *address* into a later bank.
    assigned_bank: Optional[int] = None

    @property
    def end_addr(self) -> int:
        assert self.start_addr is not None
        return self.start_addr + self.size

    def banks(self, bank_bytes: int, n_banks: int) -> List[int]:
        """All banks this buffer touches (buffers may spill across banks)."""
        assert self.start_addr is not None
        first = self.start_addr // bank_bytes
        last = (self.end_addr - 1) // bank_bytes
        return [b for b in range(first, last + 1) if b < n_banks]


@dataclasses.dataclass
class Placement:
    buffers: List[Buffer]
    strategy: str
    dev: hw.AIE2Device

    def by_name(self) -> Dict[str, Buffer]:
        return {b.name: b for b in self.buffers}

    def home_bank(self, buf: Buffer) -> int:
        """The bank a buffer's start address lies in (post overflow shift)."""
        return buf.start_addr // self.dev.bank_bytes

    def bank_of(self, buf: Buffer, assigned: bool = False) -> int:
        """Home bank, or the phase-1 *assigned* bank when requested (falls
        back to the address bank for placements without assignment)."""
        if assigned and buf.assigned_bank is not None:
            return buf.assigned_bank
        return self.home_bank(buf)

    def validate(self) -> None:
        """No overlap, all within memory."""
        bufs = sorted(self.buffers, key=lambda b: b.start_addr)
        for i, b in enumerate(bufs):
            assert b.start_addr >= 0
            assert b.end_addr <= self.dev.mem_bytes, (
                f"{b.name} ends at {b.end_addr} > {self.dev.mem_bytes}")
            if i:
                prev = bufs[i - 1]
                assert b.start_addr >= prev.end_addr, (
                    f"{prev.name} overlaps {b.name}")


def make_buffers(shape: GemmShape, p: hw.Precision,
                 include_c: bool = True) -> List[Buffer]:
    """Lines 4+7 of Algorithm 1: sizes and the (order-significant) list.

    ``include_c=False`` models the pack engines whose output lives in a
    neighbour's memory (Fig. 4): they hold only the four input buffers.
    """
    a, b, c = (shape.m * shape.k * p.in_bytes,
               shape.k * shape.n * p.in_bytes,
               shape.m * shape.n * p.out_bytes)
    bufs = [
        Buffer("ping_A", "A", "ping", a),
        Buffer("pong_A", "A", "pong", a),
        Buffer("ping_B", "B", "ping", b),
        Buffer("pong_B", "B", "pong", b),
    ]
    if include_c:
        bufs += [
            Buffer("ping_C", "C", "ping", c),
            Buffer("pong_C", "C", "pong", c),
        ]
    return bufs


# ---------------------------------------------------------------------------
# Algorithm 1 — custom buffer *address* placement
# ---------------------------------------------------------------------------


def place_buffers(shape: GemmShape, p: hw.Precision,
                  dev: hw.AIE2Device = hw.VE2802,
                  include_c: bool = True) -> Placement:
    """Faithful implementation of Algorithm 1.

    Phase 1 assigns each buffer a *bank* using the paper's rules (A/B need
    an empty bank whose neighbourhood does not hold their double; C is a
    first-fit second occupant).  Phase 2 assigns *addresses*: buffers pack
    at their bank's start, and when a bank overflows its 16 KB the paper's
    lines 27-29 shift the next bank's buffers by the overflow — i.e. a
    cascading cursor walk across banks (verified to reproduce the exact
    Table II totals, e.g. 64512 B for int8-int32).
    """
    if include_c and memory_bytes(shape, p) > dev.mem_bytes:  # line 5
        raise ValueError(
            f"buffers for {shape} @ {p.name} exceed {dev.mem_bytes} B")

    buf_list = make_buffers(shape, p, include_c)
    n_banks = dev.mem_banks
    bank_bytes = dev.bank_bytes

    # ---- Phase 1: bank assignment (two "spots" per bank) ----
    occupants: List[List[Buffer]] = [[] for _ in range(n_banks)]
    free_spots = [2] * n_banks

    def is_adjacent_conflict(buf: Buffer, bank: int) -> bool:
        """True if bank or an adjacent bank holds this buffer's double."""
        for nb in (bank - 1, bank, bank + 1):
            if 0 <= nb < n_banks:
                for other in occupants[nb]:
                    if other.matrix == buf.matrix and other.phase != buf.phase:
                        return True
        return False

    def same_bank_other_input(buf: Buffer, bank: int) -> bool:
        """Rule (c): A and B never share a bank."""
        other = "B" if buf.matrix == "A" else "A"
        return any(o.matrix == other for o in occupants[bank])

    for buf in buf_list:
        placed = False
        for bank in range(n_banks):
            if buf.matrix in ("A", "B"):
                # Lines 12-13: A/B need an empty bank (two free spots) whose
                # neighbourhood does not hold their double buffer.
                if (free_spots[bank] < 2 or is_adjacent_conflict(buf, bank)
                        or same_bank_other_input(buf, bank)):
                    continue
            else:  # Matrix C: second occupant, first fit (lines 19-26).
                if free_spots[bank] < 1:
                    continue
            occupants[bank].append(buf)
            free_spots[bank] -= 1
            buf.assigned_bank = bank
            placed = True
            break
        if not placed:
            raise ValueError(f"Algorithm 1 could not place {buf.name}")

    # ---- Phase 2: cascading address assignment (lines 15-29) ----
    cursor = 0
    for bank in range(n_banks):
        cursor = max(cursor, bank * bank_bytes)
        for buf in occupants[bank]:
            buf.start_addr = cursor
            cursor = buf.end_addr

    pl = Placement(buf_list, ADDRESS, dev)
    pl.validate()
    return pl


def place_buffers_location(shape: GemmShape, p: hw.Precision,
                           dev: hw.AIE2Device = hw.VE2802,
                           include_c: bool = True) -> Placement:
    """Model of "buffer location placement" + BufferOptLevel 0.

    The compiler only guarantees the buffers land *somewhere* in this AIE's
    memory; with the optimizer off it packs them in declaration order, which
    fragments ping/pong pairs into the same or adjacent banks — the stall
    source the paper measures (Table III, middle columns).
    """
    if include_c and memory_bytes(shape, p) > dev.mem_bytes:
        raise ValueError("does not fit")
    bufs = make_buffers(shape, p, include_c)
    addr = 0
    for b in bufs:
        b.start_addr = addr
        addr += b.size
    pl = Placement(bufs, LOCATION, dev)
    pl.validate()
    return pl


def place_buffers_unconstrained(shape: GemmShape, p: hw.Precision,
                                dev: hw.AIE2Device = hw.VE2802,
                                include_c: bool = True) -> Placement:
    """Model of BufferOptLevel 9 with no location constraint.

    The compiler is free to spill buffers into neighbouring AIEs, so each
    buffer effectively gets a private bank — no conflicts (the paper's
    best-performing but unscalable baseline).  We model it as each buffer
    on its own virtual bank: represented by spacing buffers one-per-bank in
    a widened virtual memory (only used by the stall simulator).
    """
    bufs = make_buffers(shape, p, include_c)
    # Virtual device: each buffer starts on its own bank, separated by at
    # least one empty bank so neither same-bank nor adjacent-bank overlap
    # exists (buffers spread over neighbouring AIEs share no memory port
    # with this core).
    stride = max(-(-b.size // dev.bank_bytes) for b in bufs) + 2
    vdev = dataclasses.replace(
        dev, mem_bytes=dev.bank_bytes * stride * len(bufs),
        mem_banks=stride * len(bufs))
    for i, b in enumerate(bufs):
        b.start_addr = stride * i * vdev.bank_bytes
    pl = Placement(bufs, UNCONSTRAINED, vdev)
    return pl


# ---------------------------------------------------------------------------
# Rule checkers (used by tests / property checks)
# ---------------------------------------------------------------------------


def check_rules(pl: Placement, assigned: bool = False) -> Dict[str, bool]:
    """Evaluate the paper's rules (a)-(c) on a placement.

    By default rules are judged on *home* banks (start addresses, i.e.
    after the phase-2 overflow shift).  ``assigned=True`` judges the
    phase-1 bank assignment instead — the thing the paper's rules
    actually constrain; Algorithm 1 satisfies all three there by
    construction.
    """
    by = pl.by_name()
    hb = {n: pl.bank_of(b, assigned) for n, b in by.items()}
    rule_a = all(hb[f"ping_{m}"] != hb[f"pong_{m}"] for m in "ABC")
    rule_b = all(abs(hb[f"ping_{m}"] - hb[f"pong_{m}"]) > 1 for m in "AB")
    rule_c = all(hb[f"{ph}_A"] != hb[f"{ph2}_B"]
                 for ph in ("ping", "pong") for ph2 in ("ping", "pong"))
    return {"a": rule_a, "b": rule_b, "c": rule_c}


# ---------------------------------------------------------------------------
# Bank-conflict stall simulator
# ---------------------------------------------------------------------------

# Steady state has six concurrent memory agents: the core loads the active
# (say ping) A and B buffers and stores the active C; the DMAs concurrently
# fill pong A/B from the PLIOs and drain pong C to the PLIO.  A bank is
# single-ported, so two same-cycle accesses to one bank stall the loser.
#
# The analytic model: each agent walks its buffer uniformly, so the chance
# two agents collide is (joint bank-residency) x (joint activity).  Only
# conflicts that involve the *core* stall the kernel (DMA-DMA collisions
# are absorbed by stream slack since the PLIO rate is well under bank
# bandwidth); stores are buffered and bursty, so they carry a reduced
# coefficient.  Accesses are 256-bit and may straddle a bank boundary,
# which is why the paper's rule (b) also bans *adjacent* banks for
# ping/pong pairs — modelled as a reduced adjacent-bank overlap term.

CORE_LOAD = "load"
CORE_STORE = "store"
DMA = "dma"

# Pairwise conflict coefficients (symmetric).  Stores are buffered and
# bursty (the MMUL kernel drains C after exhausting the K loop), hence the
# reduced weight; DMA-DMA collisions only delay streams that have slack.
_COEFF = {
    frozenset((CORE_LOAD, CORE_LOAD)): 1.0,
    frozenset((CORE_LOAD, DMA)): 1.0,
    frozenset((CORE_LOAD, CORE_STORE)): 0.1,
    frozenset((CORE_STORE, DMA)): 0.1,
    frozenset((CORE_STORE, CORE_STORE)): 0.1,
    frozenset((DMA, DMA)): 0.0,
}
_ADJACENT_FACTOR = 0.15


@dataclasses.dataclass(frozen=True)
class Agent:
    buffer: str     # which buffer it walks, e.g. "ping_A"
    kind: str       # CORE_LOAD | CORE_STORE | DMA
    rate: float     # bank-port utilization (accesses/cycle, <= 1)


def steady_state_agents(shape: GemmShape, p: hw.Precision,
                        dev: hw.AIE2Device,
                        phase: str) -> List[Agent]:
    """Agents active while the core computes on `phase` buffers."""
    other = "pong" if phase == "ping" else "ping"
    kcc = shape.macs / dev.macs_per_cycle(p)
    # Core issues 256-bit (32 B) loads; each tile is read once per kernel.
    a_rate = min(1.0, shape.m * shape.k * p.in_bytes / 32 / kcc)
    b_rate = min(1.0, shape.k * shape.n * p.in_bytes / 32 / kcc)
    c_rate = min(1.0, shape.m * shape.n * p.out_bytes / 32 / kcc)
    # DMA ports move 128 bits (16 B) per access at the PLIO-limited rate.
    dma_bytes_per_cycle = dev.plio_bytes_per_pl_cycle / dev.freq_ratio
    dma = min(1.0, dma_bytes_per_cycle / 16)
    dma_c = min(dma, shape.m * shape.n * p.out_bytes / 16 / kcc)
    return [
        Agent(f"{phase}_A", CORE_LOAD, a_rate),
        Agent(f"{phase}_B", CORE_LOAD, b_rate),
        Agent(f"{phase}_C", CORE_STORE, c_rate),
        Agent(f"{other}_A", DMA, dma),
        Agent(f"{other}_B", DMA, dma),
        Agent(f"{other}_C", DMA, dma_c),
    ]


def simulate_stalls_filtered(pl: Placement, shape: GemmShape,
                             p: hw.Precision) -> float:
    return simulate_stalls(pl, shape, p)


def _bank_weights(buf: Buffer, dev: hw.AIE2Device) -> Dict[int, float]:
    """Fraction of the buffer residing in each bank."""
    w: Dict[int, float] = {}
    start, end = buf.start_addr, buf.end_addr
    bank = start // dev.bank_bytes
    while start < end:
        bank_end = (bank + 1) * dev.bank_bytes
        seg = min(end, bank_end) - start
        w[bank] = w.get(bank, 0.0) + seg / buf.size
        start = min(end, bank_end)
        bank += 1
    return w


def simulate_stalls(pl: Placement, shape: GemmShape, p: hw.Precision,
                    **_unused) -> float:
    """Expected stall fraction (stall cycles per compute cycle)."""
    by = pl.by_name()
    dev = pl.dev
    total = 0.0
    for phase in ("ping", "pong"):
        agents = [a for a in steady_state_agents(shape, p, dev, phase)
                  if a.buffer in by]
        weights = {a.buffer: _bank_weights(by[a.buffer], dev) for a in agents}
        for i in range(len(agents)):
            for j in range(i + 1, len(agents)):
                ai, aj = agents[i], agents[j]
                coeff = _COEFF[frozenset((ai.kind, aj.kind))]
                if coeff == 0.0:
                    continue
                wi, wj = weights[ai.buffer], weights[aj.buffer]
                same = sum(wi.get(b, 0.0) * wj.get(b, 0.0) for b in wi)
                adj = sum(wi.get(b, 0.0) * (wj.get(b - 1, 0.0)
                                            + wj.get(b + 1, 0.0))
                          for b in wi)
                overlap = same + _ADJACENT_FACTOR * adj
                total += coeff * min(ai.rate, aj.rate) * overlap
    return total / 2.0


def stall_fraction(strategy: str, shape: GemmShape, p: hw.Precision,
                   dev: hw.AIE2Device = hw.VE2802,
                   include_c: bool = True) -> float:
    """Convenience: place with `strategy` and simulate."""
    if strategy == ADDRESS:
        pl = place_buffers(shape, p, dev, include_c)
    elif strategy == LOCATION:
        pl = place_buffers_location(shape, p, dev, include_c)
    elif strategy == UNCONSTRAINED:
        pl = place_buffers_unconstrained(shape, p, dev, include_c)
    else:
        raise ValueError(strategy)
    return simulate_stalls(pl, shape, p)
