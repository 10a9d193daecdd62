"""Stage 8: emitter radiance refinement (counterpart of
iris_tpu/pipeline/train_emitter.py; reference train_emitter.py).

Material + CRF frozen (loaded from the train_brdf_crf checkpoint,
--ckpt_path); only the emitter radiance receives gradients from
MSE(CRF(path_tracing_single), LDR). Writes emitter_last.pkl (plain
radiance) and emitter_last_state.pkl (the full training state). Runs on
the card unless --device says otherwise; --n_devices, or the multihost
flags, make it data-parallel (pipeline/common.run_ranks).
"""

from __future__ import annotations

import functools
import os
import time
from argparse import ArgumentParser
from dataclasses import replace as dc_replace

from iris_tpu_torch.data.datasets import RayBatcher, place_bank
from iris_tpu_torch.device import resolve_device
from iris_tpu_torch.models.crf import init_emor_crf
from iris_tpu_torch.parallel.distributed import is_lead
from iris_tpu_torch.pipeline.common import (
    adopt_estimator_cfg, ckpt_path, load_emitter, load_scene, load_vslf,
    make_dataset, mesh_batch_size, run_ranks, val_frame,
)
from iris_tpu_torch.pipeline.config import add_model_specific_args
from iris_tpu_torch.train.checkpoint import (
    load_pytree, load_train_state, make_state_saver, opt_state_to_numpy,
    save_pytree,
)
from iris_tpu_torch.train.loop import make_run_graphs, run_training
from iris_tpu_torch.train.optim import make_optimizer, scale_updates_for_key
from iris_tpu_torch.train.steps import (
    LossConfig, make_train_emitter_loss, param_to_radiance, radiance_to_param,
)
from iris_tpu_torch.train.validation import ScalarLogger, make_validation_hook


def main(argv=None, samples_for_step=None):
    """The stage's CLI. samples_for_step(step) -> dict replaces a step's
    draws (run_training's test hook); the command line never sets it."""
    parser = add_model_specific_args(ArgumentParser())
    parser.add_argument("--experiment_name", type=str, required=True)
    parser.add_argument("--max_steps", type=int, default=2000)
    parser.add_argument("--checkpoint_path", type=str,
                        default="./checkpoints")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--val_frame", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    if not args.ckpt_path:
        parser.error("train_emitter needs --ckpt_path (material + CRF)")
    run_ranks(main, argv, args, functools.partial(_train, args),
              samples_for_step)


def _train(args, group, samples_for_step):
    dev = group.device if group else resolve_device(args.device)
    stage = __name__.split(".")[-1]

    ds_name, ds_root = args.dataset
    scene_id = args.scene if ds_name == "scannetpp" else ""
    mesh, tracer = load_scene(ds_name, ds_root, scene_id, device=dev)
    slf, _ = load_vslf(args.voxel_path, device=dev)
    em = load_emitter(args.emitter_path, mesh, slf=slf, device=dev)
    crf = init_emor_crf(dim=args.crf_basis, device=dev)

    prev = load_pytree(args.ckpt_path, dev)
    material = adopt_estimator_cfg(prev["material"], args)
    if "crf_weight" in prev:
        crf = dc_replace(crf, weight=prev["crf_weight"])

    log_rad = bool(args.radiance_log_space)
    params = {"radiance": em.radiance.clone()}
    out = ckpt_path(args.checkpoint_path, args.experiment_name,
                    "emitter_last.pkl")
    state_out = ckpt_path(args.checkpoint_path, args.experiment_name,
                          "emitter_last_state.pkl")
    optimizer = make_optimizer(args.learning_rate, args.weight_decay,
                               tuple(args.milestones), args.scheduler_rate,
                               args.optimizer)
    optimizer = scale_updates_for_key(optimizer, "radiance",
                                      args.radiance_lr_scale)
    opt_state, start_step = None, 0
    if args.resume:
        params, opt_state, start_step = load_train_state(
            state_out, out, params, optimizer, device=dev)
    if log_rad and start_step == 0 and opt_state is None:
        # a fresh start or a params-only fallback holds PLAIN radiance; a
        # full-state resume already holds the trained log-space leaf
        params = {**params,
                  "radiance": radiance_to_param(params["radiance"])}

    dataset = make_dataset(args, "train")
    bank = dataset.pixel_bank(keys=("rays", "rgbs"))
    batcher = RayBatcher(place_bank(bank, dev), mesh_batch_size(
        args.batch_size, group and group.world_size, stage))
    if args.max_epochs:
        args.max_steps = args.max_epochs * batcher.batches_per_epoch
        print(f"[{stage}] max_epochs={args.max_epochs} -> "
              f"max_steps={args.max_steps}")

    cfg = LossConfig(spp=args.spp,
                     n_spp_rounds=max(args.SPP // args.spp, 1),
                     radiance_log_space=log_rad)
    loss_fn = make_train_emitter_loss(tracer, em, material, crf, cfg)

    # one pool for the chunks' and the validation renders' graphs
    graphs = make_run_graphs(dev, group)
    hooks = []
    if is_lead(group):      # rank 0 alone logs, validates and saves
        hooks.append(ScalarLogger(os.path.join(
            "outputs", args.experiment_name, "train_log.jsonl")))
        # validation-frame dumps during emitter training (the reference's
        # train_emitter.py renders val frames too)
        val_ds, vb = val_frame(args, stage)
        if val_ds is not None:
            hooks.append(make_validation_hook(
                tracer, em, crf, vb, val_ds.img_hw,
                os.path.join("outputs", args.experiment_name, args.dir_val),
                val_step=args.val_step, spp=args.spp,
                indir_depth=args.indir_depth, crf_gt=val_ds.crfs,
                frozen={"material": material, "crf_weight": crf.weight},
                param_tx=(lambda p: {**p, "radiance": param_to_radiance(
                    p["radiance"])}) if log_rad else None,
                graphs=graphs))

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
    # the state file keeps the TRAINED leaf (log space when enabled), so
    # that --resume is exact; the stage artifact stores plain radiance
    save_pytree(state_out, {"params": params,
                            "opt_state": opt_state_to_numpy(opt_state),
                            "step": args.max_steps})
    final = params
    if log_rad:
        final = {**final, "radiance": param_to_radiance(final["radiance"])}
    save_pytree(out, final)
    print(f"[train - emitter] time (s): {time.time() - t0:.1f}")
    print(f"[{stage}] saved", out)


if __name__ == "__main__":
    main()
