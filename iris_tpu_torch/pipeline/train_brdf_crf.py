"""Stages 6/9: BRDF + CRF optimization against cached shadings
(counterpart of iris_tpu/pipeline/train_brdf_crf.py; reference
train_brdf_crf.py, the main trainer).

Re-renders each pixel from the baked diffuse/specular caches read from
--cache_dir (L = kd*Ld + ks*lerp(spec0,r) + lerp(spec1,r)), tone-maps
through the learnable CRF, and applies the diffuse / segmentation-
propagation / albedo / CRF regularizers. --ckpt_path warm-starts the
material (and the CRF weights under --load_crf) from an earlier stage's
last.pkl. Runs on the card unless --device says otherwise; --n_devices,
or the multihost flags, make it data-parallel (pipeline/common.run_ranks).
"""

from __future__ import annotations

import functools
import os
import time
from argparse import ArgumentParser

from iris_tpu_torch.data.datasets import RayBatcher, place_bank
from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.models.crf import init_emor_crf
from iris_tpu_torch.parallel.distributed import is_lead
from iris_tpu_torch.pipeline.common import (
    adopt_estimator_cfg, build_material, ckpt_path, load_emitter,
    load_scene, load_vslf, make_dataset, mesh_batch_size, run_ranks,
    val_frame,
)
from iris_tpu_torch.pipeline.config import add_model_specific_args
from iris_tpu_torch.train.checkpoint import (
    load_pytree, load_train_state, make_state_saver, opt_state_to_numpy,
    save_pytree,
)
from iris_tpu_torch.train.loop import make_run_graphs, run_training
from iris_tpu_torch.train.optim import make_optimizer
from iris_tpu_torch.train.steps import (
    LossConfig, check_max_segments, make_brdf_crf_loss,
)
from iris_tpu_torch.train.validation import (
    ScalarLogger, make_material_diag_hook, make_validation_hook,
)


def main(argv=None, samples_for_step=None):
    """The stage's CLI. samples_for_step(step) -> dict replaces a step's
    draws (run_training's test hook); the command line never sets it."""
    parser = add_model_specific_args(ArgumentParser())
    parser.add_argument("--experiment_name", type=str, required=True)
    parser.add_argument("--max_steps", type=int, default=4000)
    parser.add_argument("--checkpoint_path", type=str,
                        default="./checkpoints")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--cache_dir", type=str, required=True)
    parser.add_argument("--val_frame", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    run_ranks(main, argv, args, functools.partial(_train, args),
              samples_for_step)


def _train(args, group, samples_for_step):
    dev = group.device if group else resolve_device(args.device)
    stage = __name__.split(".")[-1]

    ds_name, ds_root = args.dataset
    scene_id = args.scene if ds_name == "scannetpp" else ""
    mesh, tracer = load_scene(ds_name, ds_root, scene_id, device=dev)
    slf, _ = load_vslf(args.voxel_path, device=dev)
    crf = init_emor_crf(dim=args.crf_basis, device=dev)

    material = build_material(args, float(slf.voxel_min),
                              float(slf.voxel_max), device=dev)
    crf_weight = crf.weight.clone()
    if args.ckpt_path:
        prev = load_pytree(args.ckpt_path, dev)
        if "material" in prev:
            material = adopt_estimator_cfg(prev["material"], args)
        if args.load_crf and "crf_weight" in prev:
            crf_weight = prev["crf_weight"]
        print(f"[{stage}] warm start from", args.ckpt_path)
    params = {"material": material, "crf_weight": crf_weight}

    out = ckpt_path(args.checkpoint_path, args.experiment_name)
    state_out = ckpt_path(args.checkpoint_path, args.experiment_name,
                          "last_state.pkl")
    optimizer = make_optimizer(args.learning_rate, args.weight_decay,
                               tuple(args.milestones), args.scheduler_rate,
                               args.optimizer)
    opt_state, start_step = None, 0
    if args.resume:
        params, opt_state, start_step = load_train_state(
            state_out, out, params, optimizer, device=dev)
        params = adopt_estimator_cfg(params, args)

    dataset = make_dataset(args, "train", load_inverse=True,
                           has_part=bool(args.has_part),
                           cache_dir=args.cache_dir)
    bank = dataset.pixel_bank(keys=("rays", "rgbs", "segmentation",
                                    "int_albedo", "diffuse", "specular0",
                                    "specular1"))
    batcher = RayBatcher(place_bank(bank, dev), mesh_batch_size(
        args.batch_size, group and group.world_size, stage))
    if args.max_epochs:
        args.max_steps = args.max_epochs * batcher.batches_per_epoch
        print(f"[{stage}] max_epochs={args.max_epochs} -> "
              f"max_steps={args.max_steps}")
    check_max_segments(bank["segmentation"], args.max_segments)

    cfg = LossConfig(
        ld=args.ld, lp=args.lp, ls=args.ls, la=args.la,
        sigma_albedo=args.sigma_albedo, sigma_pos=args.sigma_pos,
        l_crf_increasing=args.l_crf_increasing,
        l_crf_weight=args.l_crf_weight,
        max_segments=args.max_segments, has_part=bool(args.has_part),
        n_pairs=args.n_pairs,
    )
    loss_fn = make_brdf_crf_loss(tracer, crf, cfg, float(slf.voxel_min),
                                 float(slf.voxel_max))

    log_path = os.path.join("outputs", args.experiment_name,
                            "train_log.jsonl")
    # one pool for the chunks' and the validation renders' graphs
    graphs = make_run_graphs(dev, group)
    hooks = []
    if is_lead(group):      # rank 0 alone logs, validates and saves
        hooks.append(ScalarLogger(log_path))
        val_ds, vb = val_frame(args, stage)
        if val_ds is not None:
            em = load_emitter(args.emitter_path, mesh, slf=slf, device=dev)
            hooks.append(make_validation_hook(
                tracer, em, crf, vb, val_ds.img_hw,
                os.path.join("outputs", args.experiment_name, args.dir_val),
                val_step=args.val_step, spp=args.spp,
                indir_depth=args.indir_depth, crf_gt=val_ds.crfs,
                graphs=graphs))
            hooks.append(make_material_diag_hook(tracer, vb, log_path,
                                                 val_step=args.val_step))

    t0 = time.time()
    params, opt_state = run_training(
        loss_fn, params, batcher.iter_from(start_step), optimizer,
        args.max_steps, 0, hooks=hooks, opt_state=opt_state,
        start_step=start_step,
        state_hooks=[make_state_saver(state_out, args.save_every)],
        return_state=True, chunk_steps=args.chunk_steps,
        samples_for_step=samples_for_step, group=group, graphs=graphs)
    if not is_lead(group):
        return
    save_pytree(out, params)
    save_pytree(state_out, {"params": params,
                            "opt_state": opt_state_to_numpy(opt_state),
                            "step": args.max_steps})
    print(f"[train - BRDF-emission] time (s): {time.time() - t0:.1f}")
    print(f"[{stage}] saved", out)


if __name__ == "__main__":
    main()
