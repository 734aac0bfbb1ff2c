"""End-to-end training driver. Counterpart of repro/launch/train.py.

Fault tolerance:
  * the StepSupervisor (runtime/fault.py) retries a failed step with the
    same inputs and flags stragglers;
  * committed checkpoints every `ckpt_every` steps: the parameters
    synchronously, the optimizer state through the async writer;
  * on RestartRequired the driver restores the latest committed step and
    continues, bit-exactly, because the data pipeline is seekable; a run
    also resumes from the latest committed step it finds.

The retry rule. The reference's step is a pure function, so it retries
any failure with the same inputs. The port's step computes the loss and
the gradients without writing anything, then updates the parameters and
the moments IN PLACE. A failure before that first write leaves both as
they were, so it propagates to the supervisor and is retried with the
same inputs; a failure at or after it raises RestartRequired (never
retried), and the driver restores the latest checkpoint.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama_moe_4_16 \\
      --smoke --steps 20 --seq-len 64 --global-batch 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-3b-a800m --steps 6 --seq-len 512 --fresh
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.models.layers import resolve_device
from repro_torch.models.model import loss_fn, model_init
from repro_torch.optim.adamw import (accumulate_grads, adamw_init,
                                     adamw_update, cosine_lr, tree_leaves,
                                     tree_map)
from repro_torch.runtime.fault import RestartRequired, StepSupervisor


def make_step(cfg, tc: TrainConfig, fault=None):
    """train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics), the parameters and moments updated in place. `fault(step,
    phase)`, where given, runs at phase "grads" (after the backward,
    before any write) and "update" (after the in-place update): the hook
    where tests and the chip script inject failures."""
    def train_step(params, opt_state, batch, step=-1):
        leaves = [p for p in tree_leaves(params) if p.requires_grad]
        if batch["tokens"].dim() == 3:              # [n_micro, B, S]
            grads, loss = accumulate_grads(loss_fn, params, batch, cfg)
        else:
            loss, _ = loss_fn(params, batch, cfg)
            by_leaf = dict(zip(map(id, leaves),
                               torch.autograd.grad(loss, leaves)))
            grads = tree_map(lambda p: by_leaf.get(id(p)), params)
        loss = loss.detach()
        if fault is not None:
            fault(step, "grads")
        # nothing has been written so far; from here on, a failure leaves
        # a half-updated state, which only a restore repairs
        lr = cosine_lr(opt_state.step, base_lr=tc.lr, warmup=tc.warmup_steps,
                       total=tc.steps)
        try:
            params, opt_state, m = adamw_update(
                params, grads, opt_state, lr=lr,
                weight_decay=tc.weight_decay, grad_clip=tc.grad_clip)
            if fault is not None:
                fault(step, "update")
        except RestartRequired:
            raise
        except Exception as e:
            raise RestartRequired(
                f"step {step} failed after its in-place update began: "
                f"{e}") from e
        m["loss"] = loss
        return params, opt_state, m

    return train_step


@torch.no_grad()
def _restore_into(tc: TrainConfig, step: int, params: dict, opt_state):
    """Load committed `step` into the live parameters and moments in place
    (through host memory: no second device copy); returns the optimizer
    state with the restored step count."""
    for directory, tree in ((tc.ckpt_dir, params),
                            (tc.ckpt_dir + "/opt", opt_state)):
        got = ckpt.restore(directory, step, tree, device="cpu")
        for dst, src in zip(ckpt.flatten(tree)[0], ckpt.flatten(got)[0]):
            dst.copy_(src)
    return opt_state


def run(cfg, tc: TrainConfig, *, resume: bool = True, log=print,
        device=None, params: dict | None = None, fault=None) -> dict:
    """Train `tc.steps` steps on the synthetic corpus. `params` (a
    parameter tree, e.g. bridged from the JAX package) replaces the
    seeded init; `fault` is make_step's hook. Returns losses, grad norms,
    step times, supervisor counts, and the final params and opt_state."""
    dev = resolve_device(device)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=tc.seq_len,
                      global_batch=tc.global_batch, seed=tc.seed)
    corpus = SyntheticCorpus(dcfg)
    if params is None:
        params = model_init(cfg, torch.Generator(device=dev).manual_seed(
            tc.seed), dev)
    else:
        params = tree_map(lambda p: p.to(dev), params)
    params = tree_map(lambda p: p.requires_grad_(p.is_floating_point()),
                      params)
    opt_state = adamw_init(params)
    start = 0
    if resume:
        latest = ckpt.latest_step(tc.ckpt_dir)
        if latest is not None:
            opt_state = _restore_into(tc, latest, params, opt_state)
            start = latest
            log(f"resumed from step {start}")

    step_fn = make_step(cfg, tc, fault)
    sup = StepSupervisor()
    writer = None
    losses, gnorms, step_ms = [], [], []
    t0 = time.time()
    step = start
    while step < tc.steps:
        try:
            micro = tc.microbatch
            batch = corpus.batch(step)
            if micro and tc.global_batch % micro == 0 and \
                    micro < tc.global_batch:
                n = tc.global_batch // micro
                batch = {k: v.reshape(n, micro, *v.shape[1:])
                         for k, v in batch.items()}
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            ts = time.perf_counter()
            params, opt_state, m = sup.run(step_fn, params, opt_state, batch,
                                           step, step=step)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            step_ms.append((time.perf_counter() - ts) * 1e3)
            if step % tc.log_every == 0:
                log(f"step {step:5d} loss {losses[-1]:.4f} "
                    f"gnorm {gnorms[-1]:.3f} ({time.time() - t0:.1f}s)")
            if tc.ckpt_every and (step + 1) % tc.ckpt_every == 0:
                if writer is not None:
                    writer.wait()
                ckpt.save(tc.ckpt_dir, step + 1, params, async_=False)
                writer = ckpt.save(tc.ckpt_dir + "/opt", step + 1,
                                   opt_state, async_=True)
            step += 1
        except RestartRequired as e:
            log(f"RESTART at step {step}: {e}")
            if writer is not None:
                writer.wait()
            latest = ckpt.latest_step(tc.ckpt_dir)
            if latest is None:
                raise
            opt_state = _restore_into(tc, latest, params, opt_state)
            step = latest
    if writer is not None:
        writer.wait()
    return {"losses": losses, "grad_norms": gnorms, "step_ms": step_ms,
            "steps": step - start, "stragglers": sup.stats.stragglers,
            "retries": sup.stats.retries, "params": params,
            "opt_state": opt_state}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    tc = TrainConfig(steps=args.steps, seq_len=args.seq_len,
                     global_batch=args.global_batch, lr=args.lr,
                     microbatch=args.microbatch, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every)
    out = run(cfg, tc, resume=not args.fresh, device=args.device)
    print(f"final loss {out['losses'][-1]:.4f} over {out['steps']} steps")
    return out


if __name__ == "__main__":
    main()
