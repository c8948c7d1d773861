"""End-to-end example on the PyTorch/CUDA port: serve a heterogeneous
workflow of REAL models with batched requests, scheduled by FATE on
virtual devices (the twin of ``examples/serve_workflow.py``).

Two reduced-config models (qwen3-style, glm4-style) execute a
retrieval -> 2x worker -> merge DAG over a batch of 8 queries: real
prefill + autoregressive decode per stage through the hand-written
attention kernels (built with nvcc at first use), model residency
switches, and prefix-cache bookkeeping on the serving engine.

    PYTHONPATH=src python examples/serve_workflow_torch.py            # GPU
    PYTHONPATH=src python examples/serve_workflow_torch.py --device cpu
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np                                                  # noqa: E402
import torch                                                        # noqa: E402

from repro_torch.configs.archs import SMOKE                         # noqa: E402
from repro_torch.core.devices import homogeneous_cluster            # noqa: E402
from repro_torch.core.executor import fresh_state                   # noqa: E402
from repro_torch.core.policies import make_policy                   # noqa: E402
from repro_torch.core.workflow import Stage, Workflow               # noqa: E402
from repro_torch.kernels import ops                                 # noqa: E402
from repro_torch.serving.engine import ModelBundle, ServingEngine   # noqa: E402


def make_workflow(num_queries: int = 8) -> Workflow:
    """The demo DAG: retrieve -> work_a, work_b -> merge.  ``chip_smoke.py``
    serves this same workflow at full model size."""
    stages = {
        "retrieve": Stage("retrieve", "qwen-7b", base_cost={-1: 0.01},
                          prefix_group="ctx", max_shards=2,
                          output_tokens=128),
        "work_a": Stage("work_a", "llama-8b", base_cost={-1: 0.02},
                        parents=("retrieve",), output_tokens=256),
        "work_b": Stage("work_b", "qwen-7b", base_cost={-1: 0.02},
                        prefix_group="ctx", parents=("retrieve",),
                        output_tokens=256),
        "merge": Stage("merge", "qwen-7b", base_cost={-1: 0.015},
                       prefix_group="ctx",
                       parents=("work_a", "work_b")),
    }
    return Workflow(wid="agentic-demo", stages=stages,
                    num_queries=num_queries)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    args = ap.parse_args()

    cfg_a = SMOKE["qwen3-1.7b"]
    cfg_b = dataclasses.replace(SMOKE["glm4-9b"],
                                vocab_size=cfg_a.vocab_size)
    print(f"loading model bundles (reduced configs) on {args.device}...")
    bundles = {
        "qwen-7b": ModelBundle.create("qwen-7b", cfg_a, seed=0,
                                      device=args.device),
        "llama-8b": ModelBundle.create("llama-8b", cfg_b, seed=1,
                                       device=args.device),
    }
    wf = make_workflow()

    engine = ServingEngine(bundles, n_devices=2, device=args.device,
                           gen_len=6, prompt_len=16)
    state = fresh_state(homogeneous_cluster(2))
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg_a.vocab_size, (8, 16)))
    t0 = time.perf_counter()
    results = engine.run_workflow(wf, make_policy("FATE"), state, prompts)
    wall = time.perf_counter() - t0

    print(f"\nserved {len(results)} stages x {wf.num_queries} queries "
          f"in {wall:.2f}s")
    for sid in wf.topo_order:
        r = results[sid]
        flags = []
        if r.switched:
            flags.append("model-switch")
        if r.prefix_hit:
            flags.append("prefix-hit")
        print(f"  {sid:10s} devices={r.device_ids} "
              f"tokens={tuple(r.tokens_out.shape)} wall={r.wall_s:.2f}s "
              f"{' '.join(flags)}")
    print("\nresidency:", {d.did: d.resident for d in engine.devices})
    print("kernel launches:", ops.launch_counts())


if __name__ == "__main__":
    main()
