"""Calibrated state-conditional cost coefficients (measure → fit →
profile → score/probe).

FATE's gains hinge on state-conditional cost estimation (paper §3.5),
but the proxy constants the scheduler plans against — per-model
``switch_cost``/``prefill_coef``/``decode_coef`` profiles, the global
transfer and prefix-saving scales — were hand-set.  This module closes
the loop between measured wall times (the instrumented
:mod:`repro_torch.serving.engine` trace) and the planner's cost model:

1. **Measure** — every executed stage yields a
   :class:`StageObservation`: model, query count, tokens in/out,
   residency-switch count, warm-prefix hit fraction, cross-device
   transfer volume, and the measured wall seconds.
2. **Fit** — :func:`fit_profile` solves a per-model-family
   least-squares problem over those features (the duration model is
   linear in the coefficients once the prefix term is folded into a
   combined column; see :func:`_design_matrix`), recovering
   base/prefill/decode/switch/transfer coefficients and the prefix
   saving fraction.
3. **Profile** — the result is a versioned, JSON-serializable
   :class:`CalibrationProfile`.  Loading it replaces the hand-set
   constants everywhere they are consumed: ``model_profiles()`` feeds
   ``ExecutionState.profiles`` (read by ``CostModel.switch_cost``,
   ``Scorer.future_tail``/``_model_vec``, and the admission floors in
   :mod:`repro_torch.core.admission`), ``cost_params()`` feeds ``CostModel``
   / ``FrontierPlanner`` / the executors, and the serving engine
   derives its emulated switch sleeps from the SAME object
   (:meth:`CalibrationProfile.assert_consistent` enforces agreement at
   profile-load time).  Any FIXED profile preserves the engine's bit
   parity: matrix vs scalar scoring and delta vs full rebuilds stay
   bit-identical because a profile only changes constants, never term
   order (``tests/test_calibration.py``).
4. **Probe correction** — :class:`ProbeCorrector` replaces the
   hand-set admission ``probe_margin`` with an online
   predicted-vs-observed latency correction: an EWMA of the
   observed/predicted ratio per model family, updated on every serving
   completion and fed back into every admission probe and deferral
   re-probe (:mod:`repro_torch.core.admission`).

``benchmarks/sched_bench.py --calibrate`` gates the loop end to end;
the workflow is documented in ``docs/COSTMODEL.md``.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core.costs import CostParams
from repro_torch.core.workflow import DEFAULT_PROFILES, ModelProfile

#: Schema version written into every serialized profile; bumped on any
#: incompatible change to the coefficient set or its semantics.
PROFILE_VERSION = 1

#: β reference the hand-set proxy clusters use (seconds per 1k tokens
#: moved between distinct devices, ``Cluster.transfer_coef``).  Fitted
#: per-family transfer coefficients are expressed relative to it when a
#: profile is lowered onto global ``CostParams.transfer_scale``.
REFERENCE_BETA = 0.06


@dataclasses.dataclass(frozen=True)
class StageObservation:
    """One measured stage execution — the calibration unit of evidence.

    Features are per-stage aggregates in the engine's measurement
    frame: ``queries`` queries of ``prompt_tokens`` prompt and
    ``output_tokens`` generated tokens each ran under model ``model``
    (family ``family``), causing ``switches`` residency switches, with
    a warm shared prefix covering ``prefix_fraction`` of the queries
    and ``transfer_ktokens`` thousand tokens moved across devices,
    taking ``wall_s`` measured seconds end to end on a device of
    relative ``speed``.
    """
    model: str
    family: str
    queries: int
    prompt_tokens: float
    output_tokens: float
    switches: int
    prefix_fraction: float
    transfer_ktokens: float
    wall_s: float
    speed: float = 1.0


@dataclasses.dataclass(frozen=True)
class FamilyCoefficients:
    """Fitted (or hand-set) duration coefficients for one model family.

    All values are in PROXY seconds (the unit the scheduler plans in):

    * ``base`` — per-query constant overhead;
    * ``prefill`` — seconds per 1k prompt tokens per query;
    * ``decode`` — seconds per 1k generated tokens per query;
    * ``switch`` — model weight-load (residency switch) seconds;
    * ``transfer`` — seconds per 1k tokens moved across devices;
    * ``prefix_saving`` — fraction of the prefill term saved per
      fully-warm shared-prefix query.

    The stage-duration model these parametrize is spelled out in
    :func:`predict_wall` and ``docs/COSTMODEL.md``.
    """
    base: float
    prefill: float
    decode: float
    switch: float
    transfer: float
    prefix_saving: float

    def as_dict(self) -> dict:
        """Flat float dict (JSON serialization order)."""
        return dataclasses.asdict(self)


def predict_wall(c: FamilyCoefficients, obs: StageObservation) -> float:
    """Predicted stage wall seconds (proxy units) under coefficients
    ``c`` — the generative duration model the fitter inverts:

    ``(q/speed)·(base + prefill·pk + decode·ok)
    + switches·switch + transfer_ktokens·transfer
    − prefix_fraction·(q/speed)·pk·prefill·prefix_saving``

    with ``pk``/``ok`` the prompt/output sizes in thousands of tokens.
    """
    q = obs.queries / max(obs.speed, 1e-9)
    pk = obs.prompt_tokens / 1000.0
    ok = obs.output_tokens / 1000.0
    wall = q * (c.base + c.prefill * pk + c.decode * ok)
    wall += obs.switches * c.switch
    wall += obs.transfer_ktokens * c.transfer
    wall -= obs.prefix_fraction * q * pk * c.prefill * c.prefix_saving
    return wall


def _family_means(defaults: Mapping[str, ModelProfile]
                  ) -> dict[str, tuple[float, float, float]]:
    """Per-family hand-set (switch, prefill, decode) means — the
    reference magnitudes fitted family coefficients are expressed
    against when lowered onto per-model profiles (within-family ratios
    between model sizes are preserved)."""
    groups: dict[str, list[ModelProfile]] = {}
    for prof in defaults.values():
        groups.setdefault(prof.family, []).append(prof)
    out = {}
    for fam, profs in groups.items():
        out[fam] = (
            sum(p.switch_cost for p in profs) / len(profs),
            sum(p.prefill_coef for p in profs) / len(profs),
            sum(p.decode_coef for p in profs) / len(profs),
        )
    return out


@dataclasses.dataclass(frozen=True)
class CalibrationProfile:
    """Versioned per-model-family cost coefficients — the single source
    of truth both the planner and the serving engine load.

    ``families`` maps family name → :class:`FamilyCoefficients` in
    proxy seconds.  ``fit_stats`` carries provenance per family
    (observation count, RMSE, which coefficients fell back to hand-set
    defaults because their feature column never varied).  Consumption:

    * :meth:`model_profiles` → the ``profiles`` dict of
      ``ExecutionState`` (switch costs for ``CostModel``/``Scorer``/
      admission floors);
    * :meth:`cost_params` → the :class:`~repro_torch.core.costs.CostParams`
      of ``CostModel``/``FrontierPlanner``/executors (transfer and
      prefix-saving scales);
    * the serving engine's emulated switch sleeps
      (:class:`repro_torch.serving.engine.ServingEngine`), with
      :meth:`assert_consistent` guaranteeing engine and planner read
      identical constants.

    The class is frozen: a loaded profile is immutable configuration,
    so every consumer sees the same constants for the whole run.
    """
    families: Mapping[str, FamilyCoefficients]
    version: int = PROFILE_VERSION
    source: str = "hand-set"
    fit_stats: Mapping[str, Mapping] = dataclasses.field(
        default_factory=dict)

    # -- construction ----------------------------------------------------
    @classmethod
    def hand_set(cls, defaults: Optional[Mapping[str, ModelProfile]] = None,
                 params: Optional[CostParams] = None) -> "CalibrationProfile":
        """The identity profile: hand-set constants repackaged.

        Loading it reproduces the uncalibrated system exactly
        (``model_profiles()`` returns the defaults unchanged,
        ``cost_params()`` returns the given params unchanged) — the
        baseline every fitted profile is compared against.
        """
        defaults = defaults or DEFAULT_PROFILES
        params = params or CostParams()
        fams = {}
        for fam, (sw, pf, dc) in _family_means(defaults).items():
            fams[fam] = FamilyCoefficients(
                base=0.0, prefill=pf, decode=dc, switch=sw,
                transfer=REFERENCE_BETA * params.transfer_scale,
                prefix_saving=params.prefix_saving)
        return cls(families=fams, source="hand-set")

    def perturbed(self, *, switch_mul: float = 1.0,
                  prefill_mul: float = 1.0, decode_mul: float = 1.0,
                  transfer_mul: float = 1.0,
                  prefix_saving: Optional[float] = None,
                  base: Optional[float] = None,
                  source: str = "synthetic-truth") -> "CalibrationProfile":
        """Uniformly-perturbed copy — the synthetic ground truth of the
        fit round-trip harness (``sched_bench --calibrate``,
        ``tests/test_calibration.py``): generate a trace from the
        perturbed profile, fit, and the multipliers must be recovered.
        """
        fams = {}
        for f, c in self.families.items():
            fams[f] = FamilyCoefficients(
                base=c.base if base is None else base,
                prefill=c.prefill * prefill_mul,
                decode=c.decode * decode_mul,
                switch=c.switch * switch_mul,
                transfer=c.transfer * transfer_mul,
                prefix_saving=(c.prefix_saving if prefix_saving is None
                               else prefix_saving))
        return CalibrationProfile(families=fams, source=source)

    # -- consumption -----------------------------------------------------
    def model_profiles(self, defaults: Optional[Mapping[str, ModelProfile]]
                       = None) -> dict[str, ModelProfile]:
        """Per-model profiles with this profile's family coefficients
        applied.

        Each model's hand-set switch/prefill/decode values are rescaled
        by ``family_fit / family_hand_set_mean``, preserving the
        within-family ratios between model sizes while calibrating the
        family-level magnitude.  Models of families absent from the
        profile pass through unchanged.  Feed the result to
        ``fresh_state(cluster, profiles=...)``.
        """
        defaults = defaults or DEFAULT_PROFILES
        means = _family_means(defaults)
        out: dict[str, ModelProfile] = {}
        for name, prof in defaults.items():
            fam = self.families.get(prof.family)
            if fam is None:
                out[name] = prof
                continue
            sw0, pf0, dc0 = means[prof.family]
            out[name] = dataclasses.replace(
                prof,
                switch_cost=prof.switch_cost * _ratio(fam.switch, sw0),
                prefill_coef=prof.prefill_coef * _ratio(fam.prefill, pf0),
                decode_coef=prof.decode_coef * _ratio(fam.decode, dc0))
        return out

    def cost_params(self, base: Optional[CostParams] = None
                    ) -> CostParams:
        """Global :class:`CostParams` with this profile's
        observation-weighted transfer scale and prefix saving lowered
        onto them.

        ``CostParams`` is global while the profile is per-family, so
        the per-family transfer and prefix-saving fits are collapsed to
        a mean weighted by each family's observation count (uniform
        when no fit stats are recorded — e.g. the hand-set profile).
        """
        base = base or CostParams()
        if not self.families:
            return base
        w_tr, w_ps, w_tot = 0.0, 0.0, 0.0
        for fam, c in self.families.items():
            w = float(self.fit_stats.get(fam, {}).get("n_obs", 1.0))
            w_tr += w * c.transfer
            w_ps += w * c.prefix_saving
            w_tot += w
        return dataclasses.replace(
            base,
            transfer_scale=(w_tr / w_tot) / REFERENCE_BETA,
            prefix_saving=w_ps / w_tot)

    def assert_consistent(self, profiles: Mapping[str, ModelProfile],
                          rtol: float = 1e-9) -> None:
        """Raise ``ValueError`` unless ``profiles`` (typically
        ``ExecutionState.profiles``, i.e. what the planner prices)
        matches this profile's :meth:`model_profiles` output.

        Called by the serving engine at profile-load time so
        engine-emulated switch durations and planner switch costs can
        never silently diverge again (the pre-calibration TODO this
        subsystem retires).
        """
        expect = self.model_profiles()
        for name, prof in profiles.items():
            exp = expect.get(name)
            if exp is None:
                continue
            for field in ("switch_cost", "prefill_coef", "decode_coef"):
                a, b = getattr(prof, field), getattr(exp, field)
                if not math.isclose(a, b, rel_tol=rtol, abs_tol=1e-12):
                    raise ValueError(
                        f"calibration mismatch: {name}.{field} is {a} "
                        f"in the execution state but the loaded profile "
                        f"({self.source}) expects {b} — engine and "
                        f"planner must load the same CalibrationProfile")

    def predict(self, obs: StageObservation) -> float:
        """Predicted wall seconds for one observation under this
        profile's coefficients for the observation's family."""
        c = self.families.get(obs.family)
        if c is None:
            raise KeyError(f"no coefficients for family {obs.family!r}")
        return predict_wall(c, obs)

    # -- serialization ---------------------------------------------------
    def to_json(self) -> str:
        """Serialize to the versioned JSON document CI archives next to
        ``BENCH_sched.json``."""
        return json.dumps({
            "version": self.version,
            "source": self.source,
            "families": {f: c.as_dict()
                         for f, c in sorted(self.families.items())},
            "fit_stats": {f: dict(s)
                          for f, s in sorted(self.fit_stats.items())},
        }, indent=2) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "CalibrationProfile":
        """Inverse of :meth:`to_json`; rejects unknown schema versions."""
        doc = json.loads(text)
        version = int(doc.get("version", -1))
        if version != PROFILE_VERSION:
            raise ValueError(
                f"unsupported CalibrationProfile version {version} "
                f"(expected {PROFILE_VERSION})")
        fams = {f: FamilyCoefficients(**c)
                for f, c in doc.get("families", {}).items()}
        return cls(families=fams, version=version,
                   source=doc.get("source", "unknown"),
                   fit_stats=doc.get("fit_stats", {}))

    def save(self, path) -> Path:
        """Write :meth:`to_json` to ``path``; returns the path."""
        path = Path(path)
        path.write_text(self.to_json())
        return path

    @classmethod
    def load(cls, path) -> "CalibrationProfile":
        """Read a profile previously written by :meth:`save`."""
        return cls.from_json(Path(path).read_text())


def _ratio(fit: float, ref: float) -> float:
    """Safe ``fit / ref`` rescale factor (1.0 when the reference is 0)."""
    return fit / ref if ref > 0 else 1.0


# ---------------------------------------------------------------------------
# least-squares fitting
# ---------------------------------------------------------------------------

#: Design-matrix column order; index i's coefficient lands in the
#: matching :class:`FamilyCoefficients` slot (the last column carries
#: the combined ``prefill·prefix_saving`` product — see
#: :func:`_design_matrix`).
_COLUMNS = ("base", "prefill", "decode", "switch", "transfer",
            "prefix_combined")


def _design_matrix(group: Sequence[StageObservation]
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Feature matrix ``X`` and target ``y`` for one family's
    observations.

    The duration model (:func:`predict_wall`) is bilinear in
    ``(prefill, prefix_saving)``; substituting the combined coefficient
    ``c5 = prefill · prefix_saving`` makes it linear — the fitter
    solves for ``c5`` and divides by the fitted prefill afterwards.
    """
    X = np.empty((len(group), len(_COLUMNS)))
    y = np.empty(len(group))
    for i, o in enumerate(group):
        q = o.queries / max(o.speed, 1e-9)
        pk = o.prompt_tokens / 1000.0
        ok = o.output_tokens / 1000.0
        X[i] = (q, q * pk, q * ok, o.switches, o.transfer_ktokens,
                -o.prefix_fraction * q * pk)
        y[i] = o.wall_s
    return X, y


def fit_profile(observations: Iterable[StageObservation], *,
                time_scale: float = 1.0,
                defaults: Optional[Mapping[str, ModelProfile]] = None,
                base_params: Optional[CostParams] = None,
                source: str = "fit:engine-trace") -> CalibrationProfile:
    """Fit a :class:`CalibrationProfile` from measured stage traces.

    Groups observations by model family and solves one least-squares
    problem per group over the :func:`_design_matrix` features.
    ``time_scale`` is the measurement-frame scale (wall seconds per
    proxy second — tiny test models run orders of magnitude faster than
    the 7–14B profiles the proxy costs describe); fitted coefficients
    are divided by it so the profile is always in proxy units.

    Robustness: feature columns that cannot be identified from the
    trace are dropped from the solve, and their coefficients fall back
    to the hand-set defaults, recorded per family in
    ``fit_stats[family]["defaulted"]`` (with the collinear subset also
    under ``"collinear"``) so provenance is never silent.  Two cases:

    * **no variation** — e.g. a trace that never moved tokens across
      devices cannot identify ``transfer``;
    * **collinearity** — e.g. an engine run with FIXED prompt/output
      lengths makes the base/prefill/decode columns exactly
      proportional (all three scale with ``q``); a plain least-squares
      solve would split the combined per-query rate across them
      arbitrarily and silently distort the planner's prefill-vs-decode
      pricing.  Columns are admitted greedily in
      :data:`_COLUMNS` order only while they increase the (normalized)
      design-matrix rank, so a degenerate trace keeps the hand-set
      values for the dropped coefficients instead of absorbing an
      arbitrary split.  Identifying prefill and decode separately
      requires a trace that VARIES prompt and generation lengths.

    Fitted coefficients are clipped at zero (every physical
    coefficient is nonnegative) and ``prefix_saving`` to ``[0, 1]``.
    """
    defaults = defaults or DEFAULT_PROFILES
    hand = CalibrationProfile.hand_set(defaults, base_params)
    groups: dict[str, list[StageObservation]] = {}
    for o in observations:
        groups.setdefault(o.family, []).append(o)
    fams: dict[str, FamilyCoefficients] = {}
    stats: dict[str, dict] = {}
    for fam, group in sorted(groups.items()):
        X, y = _design_matrix(group)
        y = y / time_scale
        live, collinear = _identifiable_columns(X)
        coef = np.zeros(X.shape[1])
        if live:
            sol, *_ = np.linalg.lstsq(X[:, live], y, rcond=None)
            coef[live] = np.maximum(0.0, sol)
        fallback = hand.families.get(
            fam, FamilyCoefficients(0.0, 0.0, 0.0, 0.0,
                                    REFERENCE_BETA, 0.9))
        defaulted = []
        vals = dict(zip(_COLUMNS, coef))
        for j, name in enumerate(_COLUMNS):
            if j in live:
                continue
            defaulted.append(name)
            if name == "prefix_combined":
                vals[name] = fallback.prefill * fallback.prefix_saving
            else:
                vals[name] = getattr(fallback, name)
        prefill = vals["prefill"]
        saving = (min(1.0, vals["prefix_combined"] / prefill)
                  if prefill > 1e-12 else fallback.prefix_saving)
        fams[fam] = FamilyCoefficients(
            base=vals["base"], prefill=prefill, decode=vals["decode"],
            switch=vals["switch"], transfer=vals["transfer"],
            prefix_saving=saving)
        resid = X @ np.array([vals[c] for c in _COLUMNS]) - y
        stats[fam] = {
            "n_obs": len(group),
            "rmse": float(np.sqrt(np.mean(resid ** 2))),
            "defaulted": defaulted,
            "collinear": [_COLUMNS[j] for j in collinear],
        }
    return CalibrationProfile(families=fams, source=source,
                              fit_stats=stats)


def _identifiable_columns(X: np.ndarray) -> tuple[list[int], list[int]]:
    """Split design-matrix columns into (identifiable, collinear).

    Zero columns (no variation at all) are neither.  Remaining columns
    are admitted greedily in order while they increase the rank of the
    norm-scaled submatrix; a column linearly dependent on the admitted
    set is classed collinear (its coefficient cannot be separated from
    theirs and must fall back to the hand-set default).
    """
    live: list[int] = []
    collinear: list[int] = []
    for j in range(X.shape[1]):
        col = X[:, j]
        norm = float(np.linalg.norm(col))
        if norm <= 1e-12:
            continue
        trial = live + [j]
        sub = X[:, trial]
        sub = sub / np.linalg.norm(sub, axis=0)
        if np.linalg.matrix_rank(sub, tol=1e-9) == len(trial):
            live.append(j)
        else:
            collinear.append(j)
    return live, collinear


def synthetic_trace(profile: CalibrationProfile, n: int, *,
                    seed: int = 0, noise: float = 0.0,
                    time_scale: float = 1.0) -> list[StageObservation]:
    """Generate a synthetic measured trace whose wall times follow
    ``profile`` exactly (up to multiplicative ``noise``).

    The fit round-trip harness: features are drawn uniformly over
    realistic ranges per family, wall seconds come from
    :func:`predict_wall` scaled into the measurement frame by
    ``time_scale``, and :func:`fit_profile` must recover the generating
    coefficients (``tests/test_calibration.py``).  Switch events are
    Bernoulli-sparse (like a steady-state serving trace, where most
    stage executions find their model resident) — noise is
    multiplicative on the TOTAL wall time, so a trace where every
    observation pays a multi-second switch would drown the millisecond
    token coefficients in switch-term noise.  Deterministic in
    ``seed``.
    """
    rng = np.random.default_rng(seed)
    fams = sorted(profile.families)
    out: list[StageObservation] = []
    for i in range(n):
        fam = fams[i % len(fams)]
        obs = StageObservation(
            model=f"{fam}-synthetic", family=fam,
            queries=int(rng.integers(1, 17)),
            prompt_tokens=float(rng.uniform(64, 2048)),
            output_tokens=float(rng.uniform(16, 512)),
            switches=int(rng.random() < 0.25),
            # warm prefixes are bimodal in practice — a stage either
            # misses (cold group) or hits on most of its queries; the
            # cold half also decorrelates the prefill and prefix
            # columns, conditioning the least-squares problem
            prefix_fraction=(0.0 if rng.random() < 0.5
                             else float(rng.uniform(0.5, 1.0))),
            transfer_ktokens=float(rng.uniform(0.0, 8.0)),
            wall_s=0.0,
            speed=float(rng.choice([0.7, 1.0])))
        wall = profile.predict(obs) * time_scale
        if noise:
            wall *= 1.0 + noise * float(rng.standard_normal())
        out.append(dataclasses.replace(obs, wall_s=max(wall, 0.0)))
    return out


def coefficient_errors(fitted: CalibrationProfile,
                       truth: CalibrationProfile) -> dict[str, float]:
    """Per-``family.coefficient`` relative errors of a fit against the
    generating truth (coefficients the fit marked as defaulted are
    skipped — they were never identifiable from the trace)."""
    out: dict[str, float] = {}
    for fam, true_c in truth.families.items():
        fit_c = fitted.families.get(fam)
        if fit_c is None:
            continue
        defaulted = set(fitted.fit_stats.get(fam, {})
                        .get("defaulted", ()))
        for name in ("base", "prefill", "decode", "switch", "transfer",
                     "prefix_saving"):
            if name in defaulted or (name == "prefix_saving"
                                     and "prefix_combined" in defaulted):
                continue
            t = getattr(true_c, name)
            f = getattr(fit_c, name)
            denom = abs(t) if abs(t) > 1e-9 else 1.0
            out[f"{fam}.{name}"] = abs(f - t) / denom
    return out


# ---------------------------------------------------------------------------
# online probe-error correction
# ---------------------------------------------------------------------------


class ProbeCorrector:
    """Online predicted-vs-observed latency correction (EWMA per model
    family) — the learned replacement for the hand-set admission
    ``probe_margin``.

    The admission probe predicts a workflow's completion latency; the
    serving executor later observes the real one.  This tracker keeps,
    per model family, an exponentially-weighted moving average of the
    ``observed / predicted`` ratio and serves it as the live probe
    margin: ``margin(family)`` starts at the hand-set ``prior`` (so an
    un-warmed corrector reproduces the static controller exactly) and
    converges toward the family's true ratio as completions arrive,
    tracking drift with time constant ``1/alpha`` observations.
    Ratios and margins are clipped to ``[min_margin, max_margin]`` so a
    single pathological observation (a near-zero prediction, a stalled
    workflow) cannot poison the estimate.
    """

    def __init__(self, prior: float = 1.5, alpha: float = 0.4,
                 min_margin: float = 0.25, max_margin: float = 16.0):
        self.prior = prior
        self.alpha = alpha
        self.min_margin = min_margin
        self.max_margin = max_margin
        self.margins: dict[str, float] = {}
        self.n_obs: dict[str, int] = {}

    def margin(self, family: str) -> float:
        """Current multiplicative probe margin for ``family`` (the
        prior until the first observation arrives)."""
        return self.margins.get(family, self.prior)

    def observe(self, family: str, predicted: float,
                observed: float) -> float:
        """Fold one completed workflow's ``(predicted, observed)``
        latency pair into the family's EWMA; returns the updated
        margin.  Non-positive predictions are ignored (nothing to form
        a ratio against)."""
        if predicted <= 1e-9 or observed < 0.0:
            return self.margin(family)
        ratio = min(self.max_margin,
                    max(self.min_margin, observed / predicted))
        cur = self.margins.get(family)
        if cur is None:
            new = ratio
        else:
            new = (1.0 - self.alpha) * cur + self.alpha * ratio
        self.margins[family] = new
        self.n_obs[family] = self.n_obs.get(family, 0) + 1
        return new

    def to_dict(self) -> dict:
        """Plain-JSON capture of the corrector: knobs plus the
        per-family EWMA margins and observation counts.  Inverse of
        :meth:`from_dict` — the scheduler snapshot embeds this so a
        restored control plane keeps its learned probe margins."""
        return {"prior": self.prior, "alpha": self.alpha,
                "min_margin": self.min_margin,
                "max_margin": self.max_margin,
                "margins": dict(self.margins),
                "n_obs": dict(self.n_obs)}

    @classmethod
    def from_dict(cls, doc: dict) -> "ProbeCorrector":
        """Rebuild a corrector from :meth:`to_dict` output."""
        c = cls(prior=doc["prior"], alpha=doc["alpha"],
                min_margin=doc["min_margin"],
                max_margin=doc["max_margin"])
        c.margins = dict(doc.get("margins") or {})
        c.n_obs = {k: int(n)
                   for k, n in (doc.get("n_obs") or {}).items()}
        return c
