"""Scheduling core of the port: the numpy/scipy closure that
``serving.engine.ServingEngine.run_workflow`` needs to plan with
``make_policy("FATE")`` (workflow, state, costs, scoring, solver, planner,
policies, calibration, faults).  Kept as a copy of ``repro.core``: the
port imports nothing of the JAX package."""
