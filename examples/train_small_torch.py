"""Train a reduced qwen3-family model for a few hundred steps with the
fault-tolerant trainer on the PyTorch/CUDA port: checkpointing, a
simulated node failure at three fifths of the steps, and automatic resume
(the twin of ``examples/train_small.py``).  The step runs as one captured
CUDA graph (``CapturedTrainStep``), where the reference jits it; on the
CPU the same wrapper runs it eagerly.

    PYTHONPATH=src python examples/train_small_torch.py [--steps 200]
    PYTHONPATH=src python examples/train_small_torch.py --device cpu
"""
import argparse
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch                                                     # noqa: E402

from repro_torch.configs.archs import SMOKE                      # noqa: E402
from repro_torch.launch.steps import make_train_step             # noqa: E402
from repro_torch.models.families import build_model              # noqa: E402
from repro_torch.training import optimizer as opt                # noqa: E402
from repro_torch.training.data import DataConfig, SyntheticTokens  # noqa: E402
from repro_torch.training.graphs import CapturedTrainStep        # noqa: E402
from repro_torch.training.trainer import TrainConfig, Trainer    # noqa: E402
from repro_torch.training.tree import tree_leaves, tree_map      # noqa: E402


def train(cfg, params, steps: int, device: str, log=print):
    """``steps`` steps of ``cfg`` from the float32 masters ``params`` (the
    first trainer's step takes them over: they are donated), failing at
    three fifths of them and resuming from the checkpoint; returns the
    resumed trainer's report."""
    fresh = tree_map(torch.clone, params)
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=steps)
    step_fn, _ = make_train_step(cfg, dp_size=1, global_batch=8,
                                 opt_cfg=ocfg, device=device)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, seq_len=32,
                                      global_batch=8), device=device)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_train_")
    try:
        tc = TrainConfig(steps=steps, ckpt_every=50, ckpt_dir=ckpt_dir)
        trainer = Trainer(cfg, CapturedTrainStep(step_fn), params,
                          opt.init_state(params), data, tc)
        fail_step = steps * 3 // 5
        log(f"training {steps} steps; simulated node failure at "
            f"step {fail_step}...")
        try:
            trainer.run(fail_at=fail_step)
        except RuntimeError as e:
            log(f"  !! {e} — restarting from checkpoint")
        # the first trainer's tensors were donated: the second gets its own
        trainer2 = Trainer(cfg, CapturedTrainStep(step_fn), fresh,
                           opt.init_state(fresh), data, tc)
        report = trainer2.run()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return report


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    args = ap.parse_args()

    cfg = SMOKE[args.arch]
    model = build_model(cfg, args.device)
    params = tree_map(lambda p: p.float(), model.init(
        torch.Generator(device=args.device).manual_seed(0)))
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"{cfg.name}: {n_params/1e6:.2f}M params")
    report = train(cfg, params, args.steps, args.device)
    print(f"resumed from step {report.restored_from}; finished at "
          f"step {report.final_step}")
    print(f"loss: first={report.losses[0]:.3f} "
          f"last={report.losses[-1]:.3f}")
    print(f"straggler flags: {len(report.straggler_flags)}")


if __name__ == "__main__":
    main()
