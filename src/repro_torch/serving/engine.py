"""Workflow serving engine on the GPU (the counterpart of
``repro.serving.engine``).

FATE's placements drive actual model execution on virtual devices, each
holding at most one resident model plus per-group prefix state.  Stage
execution runs real prefill + decode steps through the hand-written
attention kernels; measured wall times feed back into the execution
state, so the scheduler sees real (not proxy) stage durations.  As the
reference's bundle holds its jitted step functions, each bundle holds
its decode steps as captured CUDA graphs (``serving/graphs.py``): on the
card every decode step but the first of a new (shard batch, max_len) key
is a graph replay, with the position on the device.  The CPU runs the
same device-integer step eagerly.

All virtual devices share the one card and every bundle's weights stay on
it: residency is bookkeeping plus an emulated ``switch_sleep``, as in the
reference.  Wall-clock reads are preceded by ``torch.cuda.synchronize()``
when the device is a card, since the work they bracket is asynchronous;
inside the decode loop nothing synchronises with the host.  There is no
switch to an eager decode loop on the card: a capture that fails raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.calibration import CalibrationProfile, StageObservation
from repro_torch.core.costs import CostParams
from repro_torch.core.faults import FaultInjector, TransientStageFailure
from repro_torch.core.planner import Placement
from repro_torch.core.state import ExecutionState
from repro_torch.core.workflow import (DEFAULT_PROFILES, ModelProfile, Stage,
                                       Workflow)
from repro_torch.models.families import build_model
from repro_torch.serving.graphs import DecodeGraphs


def calibrated_switch_sleep(profile: ModelProfile,
                            cost_params: Optional[CostParams] = None,
                            time_scale: float = 1.0) -> float:
    """Emulated weight-swap duration for one model switch.

    The scheduler prices a switch at ``profile.switch_cost *
    CostParams.switch_scale`` proxy seconds (see
    :meth:`repro_torch.core.costs.CostModel.switch_cost`); the emulated
    sleep uses the SAME constants, shrunk by ``time_scale`` (1.0 means
    real-time parity).  With a loaded
    :class:`~repro_torch.core.calibration.CalibrationProfile` both sides
    read one source of truth — the engine derives ``profile`` from the
    calibration's ``model_profiles()`` and asserts at profile-load time
    that the planner's execution state carries identical constants
    (:meth:`ServingEngine.run_workflow`).
    """
    p = cost_params or CostParams()
    return profile.switch_cost * p.switch_scale * time_scale


@dataclasses.dataclass
class ModelBundle:
    """A servable model: config + weights + its decode steps
    (:class:`~repro_torch.serving.graphs.DecodeGraphs`, the counterpart of
    the reference's jitted ``decode_fn``; the prefill runs eagerly)."""
    name: str
    cfg: Any
    params: Any
    decoder: DecodeGraphs

    @classmethod
    def create(cls, name: str, cfg, seed: int = 0, device="cuda",
               params: Any = None) -> "ModelBundle":
        """Build the model on ``device`` and return the servable bundle.
        Weights are drawn from a ``torch.Generator`` seeded with ``seed``
        unless ``params`` (for example a converted tree) is given."""
        model = build_model(cfg, device)
        if params is None:
            gen = torch.Generator(device=model.device).manual_seed(seed)
            params = model.init(gen)
        bundle = cls(name, cfg, params, DecodeGraphs(model, params))
        bundle._model = model
        return bundle

    @property
    def device(self) -> torch.device:
        return self._model.device


@dataclasses.dataclass
class VirtualDevice:
    """One scheduling unit: holds at most one resident model plus saved
    prefix caches keyed by (group, model)."""
    did: int
    resident: Optional[str] = None
    prefix_caches: dict = dataclasses.field(default_factory=dict)

    def ensure_resident(self, bundle: ModelBundle,
                        switch_sleep: float = 0.0) -> bool:
        """Returns True if a switch happened.

        A residency switch drops incompatible prefix caches and — in a
        real deployment — swaps device-memory weights; the swap is
        emulated by ``switch_sleep`` seconds so measured stage times
        reflect switch cost.  The default sleep is 0 (tests must stay
        fast); calibration and measurement runs pass
        :func:`calibrated_switch_sleep`-derived values, which read the
        same :class:`~repro_torch.core.calibration.CalibrationProfile`
        constants the planner prices.
        """
        if self.resident == bundle.name:
            return False
        self.prefix_caches = {k: v for k, v in self.prefix_caches.items()
                              if k[1] == bundle.name}
        self.resident = bundle.name
        if switch_sleep:
            time.sleep(switch_sleep)
        return True


@dataclasses.dataclass
class StageResult:
    """One executed stage: outputs, wall time, and the calibration
    features the cost-model fitter consumes (tokens in/out, residency
    switches, warm-prefix coverage — see
    :meth:`ServingEngine.observations`)."""
    sid: str
    device_ids: tuple[int, ...]
    tokens_out: torch.Tensor        # [num_queries, gen_len], on the device
    wall_s: float
    switched: bool
    prefix_hit: bool
    # calibration features (measure -> fit -> profile loop)
    model: str = ""
    queries: int = 0
    prompt_tokens: int = 0          # per query
    output_tokens: int = 0          # per query
    switches: int = 0               # residency switches across shards
    prefix_fraction: float = 0.0    # fraction of queries with warm hit


class ServingEngine:
    """Executes one workflow's stages per a policy's placements.

    ``device`` is where the bundles live and the stages run (default: the
    GPU; every bundle must have been created on it).

    ``switch_sleep`` (seconds) emulates the weight swap uniformly;
    alternatively ``switch_time_scale`` derives a per-model sleep from
    the model profiles via :func:`calibrated_switch_sleep`, keeping
    measured stage times consistent with the costs the scheduler planned
    against.  Both default to off (fast tests).

    ``calibration`` loads a
    :class:`~repro_torch.core.calibration.CalibrationProfile` as the
    single source of truth for those profiles: the per-model sleeps
    derive from its fitted switch costs, and :meth:`run_workflow` asserts
    the execution state's (planner-side) profiles carry the same
    constants.

    Every executed stage is appended to ``log`` with its calibration
    features; :meth:`observations` converts the log into the
    :func:`repro_torch.core.calibration.fit_profile` input format,
    closing the measure → fit → profile loop.

    ``faults`` optionally arms a deterministic
    :class:`~repro_torch.core.faults.FaultInjector`: stage executions the
    injector targets raise
    :class:`~repro_torch.core.faults.TransientStageFailure`, and
    :meth:`run_workflow` retries them (same placement, fresh attempt
    counter) up to the plan's ``max_retries``.
    """

    def __init__(self, models: dict[str, ModelBundle], n_devices: int,
                 *, device="cuda", gen_len: int = 8, prompt_len: int = 32,
                 switch_sleep: float = 0.0,
                 switch_time_scale: float = 0.0,
                 calibration: Optional[CalibrationProfile] = None,
                 faults: Optional[FaultInjector] = None):
        self.device = resolve_device(device)
        for name, bundle in models.items():
            if bundle.device.type != self.device.type:
                raise ValueError(
                    f"bundle {name!r} lives on {bundle.device}, the engine "
                    f"runs on {self.device}")
        self.models = models
        self.devices = [VirtualDevice(i) for i in range(n_devices)]
        self.gen_len = gen_len
        self.prompt_len = prompt_len
        self.switch_sleep = switch_sleep
        self.switch_time_scale = switch_time_scale
        self.calibration = calibration
        self.faults = faults
        self.n_fault_retries = 0
        # per-model profiles the emulated sleeps derive from: the
        # loaded calibration's fit, or the hand-set defaults
        self._profiles = (calibration.model_profiles()
                          if calibration is not None
                          else dict(DEFAULT_PROFILES))
        self.log: list[StageResult] = []

    def _clock(self) -> float:
        """Host clock, read after the device has finished its queue."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _switch_sleep_for(self, bundle: ModelBundle) -> float:
        """Per-switch emulation sleep for ``bundle`` (see class doc)."""
        if self.switch_sleep:
            return self.switch_sleep
        if self.switch_time_scale:
            prof = self._profiles.get(bundle.name)
            if prof is not None:
                return calibrated_switch_sleep(
                    prof, time_scale=self.switch_time_scale)
        return 0.0

    def observations(self) -> list[StageObservation]:
        """Calibration observations for every logged stage execution.

        The engine runs each shard on its own virtual device without
        cross-device tensor movement, so ``transfer_ktokens`` is zero —
        the fitter marks the transfer coefficient as defaulted rather
        than fitting it from a feature that never varies.
        """
        out: list[StageObservation] = []
        for r in self.log:
            prof = self._profiles.get(r.model)
            out.append(StageObservation(
                model=r.model,
                family=prof.family if prof is not None else "generic",
                queries=r.queries,
                prompt_tokens=float(r.prompt_tokens),
                output_tokens=float(r.output_tokens),
                switches=r.switches,
                prefix_fraction=r.prefix_fraction,
                transfer_ktokens=0.0,
                wall_s=r.wall_s))
        return out

    @torch.inference_mode()
    def run_stage(self, wf: Workflow, stage: Stage,
                  placement: Placement,
                  prompts: torch.Tensor, attempt: int = 0) -> StageResult:
        """prompts: [num_queries, prompt_len] integer token ids.

        ``attempt`` is the retry ordinal the fault injector keys on
        (only attempt 0 is failure-eligible, so retries always
        converge); an injected fault raises
        :class:`~repro_torch.core.faults.TransientStageFailure` before
        any device state is touched.
        """
        if self.faults is not None:
            frac = self.faults.failure_fraction(
                wf.wid, stage.sid, placement.devices, attempt)
            if frac is not None:
                raise TransientStageFailure(
                    f"injected fault: stage {wf.wid}/{stage.sid} on "
                    f"devices {placement.devices} failed at "
                    f"{frac:.0%} of its run (attempt {attempt})")
        bundle = self.models[stage.model]
        if bundle.cfg.family == "audio":
            # the reference's run_stage fails here too, inside the
            # prefill's encode (ROADMAP H24)
            raise ValueError(
                f"{stage.model} ({bundle.cfg.name}) is an encoder-decoder "
                f"model, and the serving engine passes no encoder frames "
                f"to a prefill; call its prefill with extra_embeds")
        t0 = self._clock()
        n_switches = 0
        hit_queries = 0
        outs = []
        q0 = 0
        for did, nq in zip(placement.devices, placement.shard_sizes):
            if nq == 0:
                continue
            dev = self.devices[did]
            if dev.ensure_resident(bundle,
                                   self._switch_sleep_for(bundle)):
                n_switches += 1
            shard = prompts[q0: q0 + nq].to(self.device, torch.int64)
            q0 += nq
            cache_key = (stage.prefix_group, stage.model, nq)
            # prefix reuse is emulated at the bookkeeping level: a
            # saved cache marks the hit (the warm state the scheduler
            # scored for), but prefill below always starts fresh —
            # replaying the saved KV would need per-query prefix
            # alignment this substrate doesn't model.
            if (stage.cache_reuse and stage.prefix_group is not None
                    and cache_key in dev.prefix_caches):
                hit_queries += nq
            tokens, kv = bundle.decoder.generate(
                shard, self.gen_len, self.prompt_len + self.gen_len)
            if stage.keep_cache and stage.prefix_group is not None:
                # the bundle's static cache of this (shard batch,
                # max_len): every later stage of the key zeroes it and
                # decodes in it again; as a hit marker that is all the
                # same (ROADMAP H5)
                dev.prefix_caches[cache_key] = kv
            outs.append(tokens)
        tokens = torch.cat(outs, dim=0) if outs else \
            torch.zeros((0, self.gen_len), dtype=torch.int64,
                        device=self.device)
        n_q = int(tokens.shape[0])
        res = StageResult(
            stage.sid, placement.devices, tokens,
            self._clock() - t0, n_switches > 0, hit_queries > 0,
            model=stage.model, queries=n_q,
            prompt_tokens=self.prompt_len, output_tokens=self.gen_len,
            switches=n_switches,
            prefix_fraction=hit_queries / n_q if n_q else 0.0)
        self.log.append(res)
        return res

    def run_workflow(self, wf: Workflow, policy, state: ExecutionState,
                     prompts: torch.Tensor) -> dict[str, StageResult]:
        """Execute the full DAG: plan with the policy, run stages on
        the device in dependency order, update real execution state.

        With a loaded calibration profile the execution state the
        policy plans against must carry the SAME constants the engine
        emulates — asserted here, at profile-load time, so engine and
        planner can never silently diverge.
        """
        if self.calibration is not None:
            self.calibration.assert_consistent(state.profiles)
        results: dict[str, StageResult] = {}
        completed: set[str] = set()
        t_start = self._clock()
        while len(completed) < len(wf.stages):
            ready = [sid for sid in wf.topo_order
                     if sid not in completed
                     and all(p in completed for p in wf.stages[sid].parents)]
            placements = policy.plan(wf, state, ready)
            if not placements:
                sid = ready[0]
                placements = [Placement(wf.wid, sid, (0,),
                                        (wf.num_queries,))]
            for p in placements:
                if p.sid in completed:
                    continue
                stage = wf.stages[p.sid]
                max_retries = (self.faults.plan.max_retries
                               if self.faults is not None else 0)
                for attempt in range(max_retries + 1):
                    try:
                        res = self.run_stage(wf, stage, p, prompts,
                                             attempt=attempt)
                        break
                    except TransientStageFailure:
                        if attempt >= max_retries:
                            raise
                        self.n_fault_retries += 1
                results[p.sid] = res
                completed.add(p.sid)
                now = self._clock() - t_start
                state.now = now
                for d in p.devices:
                    state.set_free_at(d, now)
                    state.set_resident(d, stage.model)
                    if stage.keep_cache:
                        state.warm_prefix(d, stage.prefix_group,
                                          stage.model, wf.num_queries, now)
                state.output_loc[(wf.wid, p.sid)] = p.devices
                state.completed.add((wf.wid, p.sid))
        return results
