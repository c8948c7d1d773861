PYTHON ?= python
export PYTHONPATH := src$(if $(PYTHONPATH),:$(PYTHONPATH),)

.PHONY: test test-sched bench-sched calibrate audit docs-check \
  deprecated-check gateway-smoke check test-torch chip-smoke

test:
	$(PYTHON) -m pytest -q

# Scheduler tier: the suites that are green and need only numpy/scipy
# (kernel tests additionally need the jax/pallas toolchain).
test-sched:
	$(PYTHON) -m pytest -q tests/test_executor.py tests/test_solvers.py \
	  tests/test_workflowbench.py tests/test_score_matrix_parity.py \
	  tests/test_delta_rescoring.py tests/test_shared_frontier.py \
	  tests/test_admission.py tests/test_preemption.py \
	  tests/test_scheduler_api.py tests/test_faults.py \
	  tests/test_recovery.py tests/test_pool_partition.py \
	  tests/test_batched_probe.py tests/test_scan_index.py \
	  tests/test_scale_stress.py tests/test_multiclass.py \
	  tests/test_routing.py tests/test_gateway.py \
	  tests/test_arrival_queue.py tests/test_pools_auto.py \
	  tests/test_event_stream_live.py

# PyTorch/CUDA port, CPU tier: repro_torch against the JAX package (plain
# versions of the kernels; needs no GPU, nvcc or triton).
test-torch:
	JAX_PLATFORMS=cpu $(PYTHON) -m pytest -q tests/test_torch_*.py

# PyTorch/CUDA port, GPU tier: build the CUDA kernels with nvcc, hold them
# against their plain versions on the card, and serve the FATE-planned
# workflow at full model size (needs one NVIDIA GPU; exits nonzero without).
chip-smoke:
	python3 chip_smoke.py

bench-sched:
	$(PYTHON) -m benchmarks.sched_bench --quick --profile --serve \
	  --serve-slo --calibrate --chaos --recovery --scale --classes \
	  --gateway

# Cost-model calibration gate (fit round-trip, >=2x probe-error
# reduction vs hand-set constants, fixed-profile score-path parity);
# writes CALIBRATION_profile.json next to BENCH_sched.json.
calibrate:
	$(PYTHON) -m benchmarks.sched_bench --quick --calibrate

# Invariant auditor smoke: build a journaled chaos run in a temp dir,
# kill it mid-flight, restore from snapshot + journal replay, and
# assert the cross-structure invariants hold (tools/invariant_audit.py
# also audits archived SNAPSHOT.json / journal artifacts directly).
audit:
	$(PYTHON) tools/invariant_audit.py --self-test

# Docs gate: markdown link check over README.md/docs/ plus a
# pydocstyle-equivalent docstring lint on the documented-surface
# modules (offline container: no pydocstyle wheel, tools/docs_check.py
# implements the same checks on ast).
docs-check:
	$(PYTHON) tools/docs_check.py

# Gateway smoke: boot the asyncio HTTP gateway on an ephemeral port,
# submit one workflow over real HTTP, drain its NDJSON event stream,
# and exit nonzero if any event was dropped or the workflow never
# reached its terminal event (see serving/gateway.py --smoke).
gateway-smoke:
	$(PYTHON) -m repro.serving.gateway --smoke

# Deprecated-surface gate: fails if any in-repo caller still uses the
# policy_kwargs path outside the back-compat wrappers / parity tests
# (the typed SchedulerConfig is the supported surface).
deprecated-check:
	$(PYTHON) tools/check_deprecated.py

# CI smoke gate: scheduler tests + planner-throughput regression checks
# (sched_bench exits nonzero if the vectorized engine drops below the
# 5x wide-frontier target, if steady-state delta rescoring drops below
# the 2x guard — PR target 3x — if either engine's placements diverge
# from the reference path, if the --serve-slo control plane stops
# beating unconditional admission / loses cold-solve parity, if the
# --calibrate loop stops recovering coefficients / cutting probe error
# >= 2x / holding fixed-profile parity, if the --chaos gate stops
# completing 100% of admitted workflows under the seeded fault script
# within 2x fault-free makespan with bit-identical replay and
# empty-plan parity, if the --recovery gate stops restoring a
# killed journaled run bit-identically with clean invariant audits,
# or if the --scale gate stops completing 1000 workflows on 64
# devices with zero invariant violations under the per-event
# overhead ceiling and single-pool/monolithic parity, or if the
# --classes gate loses default-class bit-parity, platinum attainment
# under the weighted multi-class config, the bottom class's bounded-
# wait completion guarantee, or bit-identical journaled recovery of
# runs killed mid-preemption, or if the --gateway gate loses
# single-replica gateway/direct-Scheduler bit-parity, 100% completion
# under wall-clock Poisson HTTP load, routing-disabled bit-identity,
# or the routed-cheaper-than-fixed-at-quality-floor contract)
# + docs + the deprecated-surface gate.
check: test-sched bench-sched docs-check deprecated-check
