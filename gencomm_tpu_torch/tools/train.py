"""Training entry point of the port.

Counterpart of ``gencomm_tpu/tools/train.py``:

    python -m gencomm_tpu_torch.tools.train -y configs/opv2v/xxx.yaml \
        [--model_dir logs/run1] [--dataset opv2v|v2xset|v2xreal|synthetic] \
        [--epochs N] \
        [--init_from <checkpoint or model dir>] [--device cuda|cpu] \
        [--trainer kd --teacher_ckpt <checkpoint or model dir>]

The hypes yaml builds the model (``create_model``) and its criterion
(``create_loss``); ``config.yaml`` in ``--model_dir`` is authoritative and
is written there. A ``stage2`` model trains only the new agents' message
extractors, the rest frozen (``train.trainer``); the paper's baselines
train with their own schedules (``frozen_predicate``: BackAlign, CodeFilling,
STAMP, MPDA) and losses. A run resumes from the
newest ``step_N`` in its model dir unless ``--init_from`` names a
checkpoint to start from (non-strict: parameters and running statistics
where names and shapes match, the rest reported). A
``heter_pyramid_single`` model (HEAL's stage 2) trains with the restored
pyramid and heads frozen. With ``supervise_single`` (and for the single
pyramid model) the sampler also labels every agent in its own frame and the
train step runs the criterion's "_single" pass. ``--trainer kd`` distils
(DiscoNet): a teacher of the same architecture with the weights of
``--teacher_ckpt`` runs frozen beside the student, and a plain detection
criterion is upgraded to ``point_pillar_disconet_loss``. The hypes'
``noise_setting`` and ``wild_setting`` put pose noise and delay into the
frames. The data: a real dataset's loader over ``root_dir`` (``opv2v`` and
``v2xset``: ``data/opv2v.py``; ``v2xreal``: ``data/v2xreal.py``, whose
multi-class labels feed V2X-Real's losses), one pass over a seeded
permutation an epoch, or the synthetic sampler. Each epoch: the host
pipeline (loading or sampling, labels, the fusion
mode's adaptation (``Adapt``: early fusion's merged cloud, late and no
fusion's ego slot, intermediate fusion's agent-slot trimming), the C++
pillar decoration (none with ``--no_host_decorate``: a pillar encoder then
decorates the raw points on the device, ``ops/voxel.py``); a SECOND,
VoxelNet or PIXOR modality keeps its raw points) on a producer thread
or ``--workers`` processes, the steps on
the device, ``step_<epoch>`` every ``save_freq`` epochs, and the
validation loss on held-out scenes with one rolling ``bestval_at_<epoch>``
whose loss ``bestval.json`` keeps across resumes; after it a real
dataset scans its scenarios again, its CAVs shuffled anew. Runs on
``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import functools
import itertools
import json
import os
import time

import numpy as np
import torch

from gencomm_tpu_torch import resolve_device
from gencomm_tpu_torch.config.yaml_utils import load_yaml, save_yaml
from gencomm_tpu_torch.data.bucketing import (
    AGENT_BUCKETS, ego_only_batch, per_agent_label_batch, trim_agent_slots,
)
from gencomm_tpu_torch.data.decorate import HostDecoration
from gencomm_tpu_torch.data.early_fusion import merge_points_to_ego
from gencomm_tpu_torch.data.prefetch import multi_worker_iter, prefetch_iter
from gencomm_tpu_torch.loss import create_loss
from gencomm_tpu_torch.models import create_model
from gencomm_tpu_torch.pipeline import batch_to_device
from gencomm_tpu_torch.train import checkpoint, trainer
from gencomm_tpu_torch.train.metrics import MetricsLogger
from gencomm_tpu_torch.utils.pose_utils import pose_noise_enabled

DATASETS = ["opv2v", "v2xset", "dairv2x", "v2xsim", "v2xreal", "synthetic"]


def build_dataset(hypes: dict, train: bool, dataset: str):
    """The dataset of a run: a real-data loader for ``opv2v`` and
    ``v2xset`` (one directory format: ``data/opv2v.py``) and ``v2xreal``
    (``data/v2xreal.py``) over the hypes' ``root_dir`` (training) or
    ``validate_dir``; or the ``synthetic`` sampler, whose scenes'
    modalities, range, anchors and, for a camera-labelled config, spawn
    radius come from the hypes, as the JAX package derives them, and so do
    the robustness knobs: pose noise from ``noise_setting`` (where
    ``pose_noise_enabled``), the delay from ``wild_setting``
    (``async_overhead`` ms where ``async``). The sampler's agents are
    capped at ``max_cav``: the single-agent yamls (``max_cav: 1``) give one
    (the JAX package samples 2 into 1 slot and fails, ROADMAP fault q).
    ``dairv2x`` and ``v2xsim`` raise."""
    if dataset in ("opv2v", "v2xset"):
        from gencomm_tpu_torch.data.opv2v import OPV2VDataset

        return OPV2VDataset(hypes, train=train)
    if dataset == "v2xreal":
        from gencomm_tpu_torch.data.v2xreal import V2XRealDataset

        return V2XRealDataset(hypes, train=train)
    if dataset != "synthetic":
        raise NotImplementedError(
            f"dataset {dataset!r} is not ported yet (ROADMAP item 20); "
            "use --dataset synthetic, opv2v, v2xset or v2xreal")
    from gencomm_tpu_torch.data.synthetic import (
        SyntheticConfig, SyntheticScenes,
    )

    ns = hypes.get("noise_setting", {}) or {}
    nargs = ns.get("args", {}) if pose_noise_enabled(ns) else {}
    ws = hypes.get("wild_setting", {}) or {}
    margs = hypes.get("model", {}).get("args", {})
    core = hypes.get("model", {}).get("core_method", "").lower()
    # per-agent labels: the supervise_single pass, the single pyramid
    # model's heads over every agent and the per-slot legacy detectors
    needs_single = bool(margs.get("supervise_single")) or any(
        core.startswith(c) for c in PER_SLOT_PREFIXES)
    modalities = {}
    spawn_radius = 0.0
    for name, m in margs.items():
        if isinstance(m, dict) and "encoder_args" in m:
            if m.get("sensor_type", "lidar") == "camera":
                dac = m["encoder_args"]["data_aug_conf"]
                modalities[name] = {"sensor": "camera",
                                    "final_dim": tuple(dac["final_dim"]),
                                    "ncam": int(dac.get("Ncams", 4))}
                if hypes.get("label_type") == "camera":
                    # keep every GT box within the depth discretization
                    dmax = m["encoder_args"]["grid_conf"]["ddiscr"][1]
                    spawn_radius = float(dmax) - 2.0
            else:
                modalities[name] = {"sensor": "lidar"}
    if not modalities:
        modalities = {"m1": {"sensor": "lidar"}}
    aa = hypes.get("postprocess", {}).get("anchor_args", {})
    vs = hypes.get("preprocess", {}).get("args", {}).get(
        "voxel_size", (0.4, 0.4, 4.0))
    max_cav = hypes["train_params"]["max_cav"]
    cfg = SyntheticConfig(
        lidar_range=tuple(hypes["preprocess"]["cav_lidar_range"]),
        pos_std=float(nargs.get("pos_std", 0.0)),
        rot_std=float(nargs.get("rot_std", 0.0)),
        laplace_noise=bool(nargs.get("laplace", False)),
        delay_ms=float(ws.get("async_overhead", 0.0)) if ws.get("async")
        else 0.0,
        max_cav=max_cav,
        num_agents=min(SyntheticConfig.num_agents, max_cav),
        per_agent_labels=needs_single,
        modalities=modalities,
        max_spawn_radius=spawn_radius,
        voxel_size=tuple(vs),
        feature_stride=int(aa.get("feature_stride", 4)),
        anchor_l=float(aa.get("l", 3.9)),
        anchor_w=float(aa.get("w", 1.6)),
        anchor_h=float(aa.get("h", 1.56)),
        anchor_yaw_deg=tuple(aa.get("r", (0.0, 90.0))),
    )
    return SyntheticScenes(cfg)


def batches(dataset, batch_size: int, seed: int, dataset_kind: str):
    """Synthetic: endless batches ``sample(seed * 10000 + step, B)``. A
    real dataset: one pass over a permutation seeded with ``seed``, B
    samples a batch, collated (a last partial batch dropped)."""
    if dataset_kind == "synthetic":
        step = 0
        while True:
            yield dataset.sample(seed * 10000 + step, batch_size)
            step += 1
    idx = np.random.RandomState(seed % (2 ** 32)).permutation(len(dataset))
    for start in range(0, len(idx) - batch_size + 1, batch_size):
        yield dataset.collate([dataset[i]
                               for i in idx[start: start + batch_size]])


# the per-slot legacy detectors, which train every agent as a sample on
# its own-frame labels (the JAX CLI's list; ``second`` is ported, ROADMAP
# item 19 ports the others)
PER_SLOT_CORES = ("ciassd", "second", "second_ssfa", "fpvrcnn",
                  "second_ssfa_uncertainty", "point_pillar_uncertainty")
# the cores whose sampler draws per-agent labels (the JAX CLI's
# build_dataset: the legacy detectors by prefix, so second_intermediate
# too, and the single pyramid model)
PER_SLOT_PREFIXES = ("ciassd", "second", "fpvrcnn",
                     "point_pillar_uncertainty", "heter_pyramid_single")


class Adapt:
    """The host adaptation of a sampled batch, by fusion mode as the JAX CLI
    adapts it: early fusion merges the clouds into the ego frame
    (``merge_points_to_ego``, masked to the lidar range; the per-agent
    labels cut to the ego's, fault r); a per-slot core
    trains each agent on its own labels (``per_agent_label_batch``); late
    and no fusion take the ego slot (``ego_only_batch``); intermediate
    fusion trims to the smallest of the model's ``agent_buckets``
    (``trim_agent_slots``; a CoBEVT model's batches keep the agent count it
    was built for). Then the C++ pillar decoration of the lidar modalities,
    unless ``host_decorate`` is false (the raw-point pillar path). Sent to
    worker processes whole."""

    def __init__(self, hypes: dict, buckets=AGENT_BUCKETS,
                 host_decorate: bool = True):
        fusion_mode = hypes.get("fusion", {}).get("core_method", "").lower()
        core = hypes["model"]["core_method"].lower()
        self.lidar_range = hypes["preprocess"]["cav_lidar_range"]
        self.mode = ("early" if fusion_mode == "early"
                     else "per_slot" if core in PER_SLOT_CORES
                     else "ego" if fusion_mode in ("late", "no")
                     else "trim")
        self.decorate = HostDecoration(hypes) if host_decorate else None
        self.buckets = buckets

    def __call__(self, batch):
        if self.mode == "early":
            # the one merged agent is the ego, whose own-frame labels are
            # its slot's: the JAX CLI keeps every slot's, and a
            # supervise_single step then fails (ROADMAP fault r)
            batch = {k: v[:, :1] if k.endswith("_single") else v
                     for k, v in merge_points_to_ego(
                         batch, self.lidar_range).items()}
        elif self.mode == "per_slot":
            batch = per_agent_label_batch(batch)
        elif self.mode == "ego":
            batch = ego_only_batch(batch)
        else:
            batch = trim_agent_slots(batch, buckets=self.buckets)
        return batch if self.decorate is None else self.decorate(batch)


def epoch_batches(dataset, batch_size: int, dataset_kind: str, adapt,
                  seed: int, worker: int):
    """A worker's adapted batches (seed stream ``seed * 100 + worker``)."""
    return map(adapt, batches(dataset, batch_size, seed * 100 + worker,
                              dataset_kind))


def frozen_predicate(args, hypes: dict):
    """The freeze schedule, in the JAX CLI's order: ``--freeze_prefixes``;
    the stage-2 protocol's for a ``stage2`` model; BackAlign's (the fusion,
    the shared heads and the ego's branch, by exact name); HEAL's for
    ``heter_pyramid_single`` (the shared pyramid and the heads frozen: only
    the new agent's encoder, backbone and aligner learn); CodeFilling's
    (only the ``codebook`` trains); STAMP's (only the adapters and
    reverters); MPDA's (the modality branches frozen). None trains
    everything."""
    core = hypes["model"]["core_method"].lower()
    if args.freeze_prefixes:
        return trainer.freeze_by_prefixes(args.freeze_prefixes.split(","))
    if "stage2" in core:
        trainable = trainer.stage2_trainable_prefixes(hypes)
        print("stage-2 freeze: training only", trainable)
        return trainer.freeze_all_except(trainable)
    if "backalign" in core:
        frozen = trainer.backalign_frozen_modules(hypes)
        print("backalign freeze:", frozen)
        return trainer.freeze_exact(frozen)
    if core == "heter_pyramid_single":
        print("pyramid-single freeze: ['pyramid_backbone', 'heads']")
        return trainer.freeze_by_prefixes(["pyramid_backbone", "heads"])
    if "codebook" in core:
        print("codebook freeze: training only ['codebook']")
        return trainer.freeze_all_except(["codebook"])
    if "stamp" in core:
        print("stamp freeze: training only adapters/reverters")
        return trainer.freeze_all_except(["adapter_", "reverter_"])
    if "mpda" in core:
        print("mpda freeze: branches frozen")
        return trainer.freeze_by_prefixes(["branch_"])
    return None


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--hypes_yaml", "-y", required=True)
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--dataset", default="opv2v", choices=DATASETS)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--steps_per_epoch", type=int, default=50)
    parser.add_argument("--freeze_prefixes", default="",
                        help="comma-separated parameter-path prefixes to "
                             "freeze")
    parser.add_argument("--init_from", default=None,
                        help="checkpoint (or model dir) for a non-strict "
                             "restore")
    parser.add_argument("--trainer", default="plain",
                        choices=["plain", "kd", "gmatch"])
    parser.add_argument("--teacher_ckpt", default=None)
    parser.add_argument("--val_steps", type=int, default=5,
                        help="validation batches per eval (0 disables the "
                             "val loop and bestval tracking)")
    parser.add_argument("--run_test", action="store_true",
                        help="run inference on the final checkpoint")
    parser.add_argument("--batch_pool", type=int, default=0,
                        help="build N batches per epoch and cycle through "
                             "them (a host-bound run becomes device-bound); "
                             "validation still draws fresh scenes")
    parser.add_argument("--workers", type=int, default=0,
                        help="host-pipeline worker processes; 0 = one "
                             "producer thread")
    parser.add_argument("--half", action="store_true",
                        help="bf16 training: not ported")
    parser.add_argument("--no_host_decorate", action="store_true",
                        help="no C++ pillar decoration on the host: a "
                             "pillar encoder decorates the raw points on "
                             "the device")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.trainer == "gmatch":
        raise NotImplementedError(
            "--trainer gmatch is not ported yet (ROADMAP item 16)")
    if args.trainer == "kd" and not args.teacher_ckpt:
        raise SystemExit("--trainer kd requires --teacher_ckpt")
    if args.half:
        raise NotImplementedError(
            "bf16 training (--half) is not ported yet (ROADMAP section 2: "
            "bf16 K1b and K3b)")
    device = resolve_device(args.device)

    hypes = load_yaml(args.hypes_yaml, args.model_dir)
    model_dir = args.model_dir or os.path.join(
        "logs", hypes.get("name", "run") + time.strftime("_%m%d_%H%M%S"))
    os.makedirs(model_dir, exist_ok=True)
    save_yaml(hypes, os.path.join(model_dir, "config.yaml"))

    dataset = build_dataset(hypes, True, args.dataset)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = create_model(hypes, device=device)
    criterion = create_loss(hypes)
    adapt = Adapt(hypes, model.agent_buckets,
                  host_decorate=not args.no_host_decorate)
    frozen = frozen_predicate(args, hypes)
    opt, sched = trainer.make_optimizer(hypes, model.named_parameters(),
                                        args.steps_per_epoch, frozen)

    step, start_epoch = 0, 0
    if args.init_from:
        path = checkpoint.latest_checkpoint(args.init_from) or args.init_from
        restored = checkpoint.load_checkpoint(path)
        model.load_state_dict(checkpoint.load_into(model.state_dict(),
                                                   restored["state_dict"]))
        print(f"initialised from {path}")
    else:
        latest = checkpoint.latest_checkpoint(model_dir)
        if latest:
            # parameters, running statistics and the update count; the
            # optimizer's moments restart, as in the JAX package
            restored = checkpoint.load_checkpoint(latest)
            model.load_state_dict(checkpoint.load_into(
                model.state_dict(), restored["state_dict"]))
            step = int(restored.get("step", 0))
            start_epoch = step // max(args.steps_per_epoch, 1)
            print(f"resumed from {latest} (epoch {start_epoch})")

    if args.trainer == "kd":
        from gencomm_tpu_torch.loss.point_pillar_loss import (
            PointPillarDiscoNetLoss,
        )

        if not isinstance(criterion, PointPillarDiscoNetLoss):
            # as the JAX CLI: a plain detection config gets the KD term
            criterion = PointPillarDiscoNetLoss(hypes["loss"]["args"])
            print("trainer kd: upgraded criterion to PointPillarDiscoNetLoss "
                  f"(kd weight {criterion.kd_weight})")
        teacher = create_model(hypes, device=device)
        tpath = (checkpoint.latest_checkpoint(args.teacher_ckpt)
                 or args.teacher_ckpt)
        teacher.load_state_dict(checkpoint.load_checkpoint(tpath)["state_dict"])
        teacher.requires_grad_(False)
        print(f"trainer kd: teacher from {tpath}")
        step_fn = trainer.make_kd_train_step(model, teacher, criterion, opt,
                                             sched)
    else:
        step_fn = trainer.make_train_step(
            model, criterion, opt, sched, frozen_predicate=frozen,
            supervise_single=bool(hypes["model"]["args"].get(
                "supervise_single")))
    eval_fn = trainer.make_eval_step(model, criterion)
    batch_size = hypes["train_params"]["batch_size"]
    epochs = args.epochs or hypes["train_params"]["epoches"]
    eval_freq = hypes["train_params"].get("eval_freq", 1)
    save_freq = hypes["train_params"].get("save_freq", 1)
    val_dataset = build_dataset(hypes, False, args.dataset)
    best_val = float("inf")
    best_path = os.path.join(model_dir, "bestval.json")
    if os.path.exists(best_path):
        with open(best_path) as f:
            best_val = float(json.load(f).get("val_loss", float("inf")))
    metrics = MetricsLogger(model_dir)

    for epoch in range(start_epoch, epochs):
        src = map(adapt, batches(dataset, batch_size, epoch, args.dataset))
        if args.batch_pool > 0:
            gen = prefetch_iter(itertools.cycle(
                [next(src) for _ in range(args.batch_pool)]))
        elif args.workers > 0:
            gen = multi_worker_iter(functools.partial(
                epoch_batches, dataset, batch_size, args.dataset, adapt,
                epoch), args.workers)
        else:
            gen = prefetch_iter(src)
        # the diffusion's noise: one generator an epoch on the model's device
        generator = torch.Generator(device=device).manual_seed(epoch * 100003)
        tick, tick_it, done = None, 0, 0
        for it in range(args.steps_per_epoch):
            try:
                host = next(gen)
            except StopIteration:
                break
            losses = step_fn(batch_to_device(host, device), generator=generator)
            step += 1
            done += 1
            if it % 10 == 0:
                # float() waits for the step, so the clock below measures
                # the whole step, host work included
                msg = " ".join(f"{k}={float(v):.4f}" for k, v in losses.items())
                now = time.perf_counter()
                rate = ""
                if tick is not None and it > tick_it:
                    rate = (f" [{(now - tick) / (it - tick_it) * 1e3:.1f} "
                            "ms/step]")
                tick, tick_it = now, it
                print(f"[epoch {epoch}][{it}] {msg}{rate}", flush=True)
                metrics.log(epoch * args.steps_per_epoch + it, losses,
                            prefix="train/")
                if it == 0:
                    first = now
        if done > 1:
            # the epoch's steps after its first, loading included: the
            # rate a user's run reaches
            float(losses["total_loss"])
            ms = (time.perf_counter() - first) / (done - 1) * 1e3
            print(f"[epoch {epoch}] {ms:.1f} ms/step over steps 1-"
                  f"{done - 1}", flush=True)
            metrics.log(epoch * args.steps_per_epoch + done - 1,
                        {"ms_per_step": ms}, prefix="train/")
        gen.close()
        if hasattr(dataset, "reinitialize"):
            # the scenario database again, its CAVs shuffled anew
            dataset.reinitialize()
        if (epoch + 1) % save_freq == 0:
            path = checkpoint.save_checkpoint(model_dir, model.state_dict(),
                                              step, epoch=epoch + 1)
            print(f"saved {path}", flush=True)
        if args.val_steps > 0 and (epoch + 1) % eval_freq == 0:
            vgen = batches(val_dataset, batch_size, 99000 + epoch % 1000,
                           args.dataset)
            vtotal, vn = 0.0, 0
            for vit in range(args.val_steps):
                try:
                    vbatch = batch_to_device(adapt(next(vgen)), device)
                except StopIteration:
                    break
                vgenerator = torch.Generator(device=device).manual_seed(
                    777 + vit)
                vlosses = eval_fn(vbatch, generator=vgenerator)
                vtotal += float(vlosses["total_loss"])
                vn += 1
            if not vn:
                continue
            vavg = vtotal / vn
            print(f"[epoch {epoch}] val loss {vavg:.4f} (best {best_val:.4f})",
                  flush=True)
            metrics.log((epoch + 1) * args.steps_per_epoch,
                        {"total_loss": vavg}, prefix="val/")
            if vavg < best_val:
                best_val = vavg
                bpath = checkpoint.save_bestval(model_dir, model.state_dict(),
                                                step, epoch + 1)
                with open(best_path, "w") as f:
                    json.dump({"val_loss": best_val, "epoch": epoch + 1}, f)
                print(f"new bestval -> {bpath}", flush=True)
    checkpoint.save_checkpoint(model_dir, model.state_dict(), step,
                               epoch=epochs)
    metrics.close()
    print("training done:", model_dir)
    if args.run_test:
        from gencomm_tpu_torch.tools import inference

        inference.main(["--model_dir", model_dir, "--dataset", args.dataset,
                        "--frames", "5", "--device", args.device])
    return model_dir


if __name__ == "__main__":
    main()
