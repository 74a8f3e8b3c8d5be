"""Elastic recovery runtime: health-tracked fault domains and the canary-
validated climb BACK UP the degradation ladder (DESIGN.md §14).

The port's copy of the single-device part of ``repro.runtime.recovery``
(pure Python; the reference module cannot be imported without the JAX
package).  Injected ``EngineFailure``s step serving down
``core.lstm.DEGRADATION_LADDER`` (``cuda_seq_fused_systolic`` ->
``cuda_seq_fused`` -> ``cuda_seq`` -> ``torch_scan``); this module is the
recovery half:

  * ``Rung`` / ``build_rungs`` — the degradation ladder materialised as an
    explicit rung list: on a two-level ``launch.mesh.DieMesh`` the top
    rungs are the same systolic dispatch on progressively fewer dies (real
    intermediate rungs: ``graves-3x25`` runs 75 -> 50 -> 25 engines),
    below which the ladder continues through the flat single-device
    backends down to ``torch_scan``.  Every rung records how many healthy
    fault domains it needs, which is what makes capacity a pure function
    of tracker state.
  * ``MeshHealthTracker`` — per-domain health fed by the injection
    schedules (``ServingFaultConfig.fail_at`` / ``recover_at``), with
    exponential-backoff hysteresis: a failure landing inside the
    post-promotion window doubles the backoff, as does a rejected canary,
    so a flapping engine settles at the hysteresis floor instead of
    oscillating the backend (never more than one promotion per window).
  * the **canary protocol** lives in ``serving/engine.py`` on top of the
    launch/commit core: when the tracker reports capacity for a higher
    rung, the engine drains in-flight work, replays the last committed
    chunk as a SHADOW on the candidate backend against the committed input
    state, and promotes only on bit-equality with the incumbent's
    committed result — a failed canary squashes un-committed with a
    ``promote_rejected`` event and a longer backoff.

Pure control-plane code: nothing here touches numerics — rungs select
*which* kernel executes, the §7 masking contract keeps outputs equal
across chunk boundaries, and promotion is refused unless the canary proves
the candidate agrees bit-for-bit (or within an explicit ``canary_rtol``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Rung:
    """One rung of the materialised degradation/recovery ladder.

    ``backend`` is the ``core.lstm`` dispatch name that executes on this
    rung; ``n_dies`` is the number of healthy dies the rung's mesh spans
    (None for flat single-host rungs that use no mesh); ``need`` is the
    number of healthy fault domains required to OCCUPY the rung — the
    tracker compares it against ``len(healthy)`` to decide both where a
    failure lands and when capacity exists for a promotion.
    """

    backend: str
    n_dies: Optional[int] = None
    need: int = 0

    def label(self) -> str:
        """Human-readable rung name for event/CLI surfaces."""
        if self.n_dies is None:
            return self.backend
        return f'{self.backend}@{self.n_dies}d'


def build_rungs(home_backend: str, *, n_layers: int, n_h: int,
                die_mesh=None, n_x: int = 0, T: int = 0,
                batch: int = 0) -> Tuple[Rung, ...]:
    """Materialise the degradation ladder for one serving deployment.

    Without a die mesh this is ``DEGRADATION_LADDER`` from
    ``home_backend`` down to ``torch_scan``, one fault domain per rung
    transition (rung ``i`` needs ``len - 1 - i`` healthy domains, the
    bottom needs none).  With a two-level ``launch.mesh.DieMesh`` and a
    systolic home, the top of the ladder is the systolic dispatch on
    k = dies .. 1 dies, each rung checked against the admission rule on
    its flattened ``submesh``: ``cuda_seq_fused_systolic@kd`` (need k)
    where k * stage >= 2 and the stage-aware rule admits the stack (with
    the shape context ``n_x``, ``T``, ``batch``), ``cuda_seq_systolic@kd``
    where k * stage == 1 and the single-layer rule admits the layer.  The
    flat ladder continues below the smallest such rung, with need 0 on
    every rung.  Pure selection: every rung runs the same chunking and
    masking contract, so rung changes never change what a stream computes,
    only which engines compute it.  Raises ``ValueError`` for a home that
    is off the ladder."""
    from ..core.lstm import DEGRADATION_LADDER, next_backend_down
    rungs: List[Rung] = []
    tail_home = home_backend
    if die_mesh is not None and home_backend.endswith('_systolic'):
        from ..core.systolic import seq_scaleout_admissible
        for k in range(die_mesh.dies, 0, -1):
            sub = die_mesh.submesh(range(k))
            stages = k * die_mesh.stage
            if stages >= 2 and seq_scaleout_admissible(
                    n_h, sub, n_layers=n_layers, n_x=n_x, T=T, batch=batch):
                rungs.append(Rung('cuda_seq_fused_systolic', n_dies=k,
                                  need=k))
            elif stages == 1 and seq_scaleout_admissible(n_h, sub):
                rungs.append(Rung('cuda_seq_systolic', n_dies=k, need=k))
        tail_home = next_backend_down(rungs[-1].backend if rungs
                                      else home_backend)
    flat: List[str] = []
    if tail_home is not None:
        flat = [tail_home]
        while True:
            nxt = next_backend_down(flat[-1])
            if nxt is None:
                break
            flat.append(nxt)
    if rungs:
        # the flat tail below the die rungs: reachable with zero dies
        rungs.extend(Rung(b, need=0) for b in flat)
    else:
        rungs = [Rung(b, need=len(flat) - 1 - i) for i, b in enumerate(flat)]
    if not rungs or rungs[-1].backend not in DEGRADATION_LADDER:
        raise ValueError(f'{home_backend!r} is not on the degradation '
                         f'ladder {DEGRADATION_LADDER}')
    return tuple(rungs)


class MeshHealthTracker:
    """Per-fault-domain health with exponential-backoff promotion hysteresis.

    Tracks which of ``n_domains`` fault domains (dies on a two-level mesh,
    virtual engine groups on a flat ladder) are healthy, and *when* the
    engine is allowed to attempt a promotion:

      * ``fail`` marks domains dead (attributed by id, else LIFO from the
        highest-numbered healthy domain — matching ``heal``'s revival
        order so fail/heal schedules compose deterministically).  A
        failure landing within one hysteresis window of the last promotion
        is a FLAP: the backoff doubles (capped) instead of resetting, so
        an engine that keeps dying right after re-admission waits
        geometrically longer each round.
      * ``heal`` revives domains LIFO (most recently failed first).
      * ``can_promote`` is the hysteresis gate: promotions are barred
        until the backoff window since the last fail/promote/reject has
        passed — never more than one promotion per window.
      * ``note_promote`` / ``note_reject`` feed the outcome back: a
        successful promotion re-arms a plain window; a rejected canary
        doubles the backoff (the candidate is provably not ready).

    Deterministic given the fed (step, event) sequence — tests replay
    schedules exactly.  Control-plane only: the tracker never touches
    state or numerics, it only gates *when* the engine may try to climb.
    """

    def __init__(self, n_domains: int, hysteresis: int = 4,
                 max_backoff: int = 64):
        if n_domains < 0 or hysteresis < 1:
            raise ValueError(f'need n_domains >= 0 and hysteresis >= 1, got '
                             f'{n_domains}, {hysteresis}')
        self.n_domains = int(n_domains)
        self.hysteresis = int(hysteresis)
        self.max_backoff = int(max_backoff)
        self._dead: List[int] = []          # LIFO order of failed domains
        self._backoff = self.hysteresis
        self._not_before = 0                # first step a promotion may land
        self._last_promote: Optional[int] = None

    @property
    def healthy(self) -> Tuple[int, ...]:
        """Sorted ids of the currently healthy fault domains."""
        dead = set(self._dead)
        return tuple(d for d in range(self.n_domains) if d not in dead)

    @property
    def n_healthy(self) -> int:
        """Number of healthy fault domains (the capacity the rung ``need``
        fields are compared against)."""
        return self.n_domains - len(self._dead)

    @property
    def backoff(self) -> int:
        """The current hysteresis window length in engine steps (doubles on
        flaps and rejected canaries, capped at ``max_backoff``)."""
        return self._backoff

    def fail(self, step: int, domain: Optional[int] = None,
             n_dead: int = 1) -> Tuple[int, ...]:
        """Mark ``n_dead`` domains dead at ``step`` (attributed to
        ``domain`` when given, else LIFO from the highest healthy id);
        returns the ids actually killed.  Arms/extends the promotion
        backoff; a failure inside the post-promotion window is a flap and
        doubles it."""
        killed: List[int] = []
        for _ in range(max(1, int(n_dead))):
            alive = [d for d in range(self.n_domains) if d not in self._dead]
            if not alive:
                break
            pick = domain if (domain is not None and domain in alive) \
                else alive[-1]
            self._dead.append(pick)
            killed.append(pick)
            domain = None      # n_dead > 1 spills onto LIFO picks
        flap = (self._last_promote is not None
                and step - self._last_promote < self._backoff)
        if flap:
            self._backoff = min(2 * self._backoff, self.max_backoff)
        else:
            self._backoff = self.hysteresis
        self._not_before = step + self._backoff
        return tuple(killed)

    def heal(self, step: int, n_healed: int = 1) -> Tuple[int, ...]:
        """Revive ``n_healed`` domains at ``step`` (LIFO: most recently
        failed first); returns the ids revived.  Healing restores CAPACITY
        only — the promotion still waits for the hysteresis gate and must
        pass the canary."""
        revived: List[int] = []
        for _ in range(max(1, int(n_healed))):
            if not self._dead:
                break
            revived.append(self._dead.pop())
        return tuple(revived)

    def can_promote(self, step: int) -> bool:
        """The hysteresis gate: True iff the backoff window since the last
        fail/promote/reject has fully elapsed at ``step``."""
        return step >= self._not_before

    def note_promote(self, step: int) -> None:
        """Record a landed promotion: re-arms one plain hysteresis window
        (so at most one promotion per window) and marks the flap
        reference point."""
        self._last_promote = step
        self._not_before = step + self._backoff

    def note_reject(self, step: int) -> None:
        """Record a rejected canary: the candidate is provably not ready,
        so the backoff doubles (capped) and the window re-arms."""
        self._backoff = min(2 * self._backoff, self.max_backoff)
        self._not_before = step + self._backoff

    def best_rung(self, rungs: Sequence[Rung], current: int,
                  step: Optional[int] = None) -> int:
        """The rung index the fleet's health supports right now.

        Degraded direction: the first (highest) rung whose ``need`` is
        within capacity, but never above ``current`` unless the hysteresis
        gate is open — and promotions climb ONE rung at a time (each must
        canary-validate individually).  Pure policy arithmetic; the engine
        owns the actual rebuild."""
        n = self.n_healthy
        supported = next((i for i, r in enumerate(rungs) if r.need <= n),
                         len(rungs) - 1)
        if supported >= current:
            return supported
        if step is not None and not self.can_promote(step):
            return current
        return current - 1
