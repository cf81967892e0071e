"""Command-line interface of the port (counterpart of ``msnets_tpu/cli.py``):

    python -m msnets_tpu_torch.cli --mode test --resume CKPT ...

Flag-compatible with the JAX package's CLI (and so with the reference
trainer, main_msnet.py:803-838): the same flags, destinations and defaults,
so its command lines parse unchanged. Modes: train, loop-train (each epoch
resumes the previous epoch's checkpoint), test, val-30 and cross-val (the
evaluator), eval-badx (re-scoring saved PFMs).

Everything runs on the GPU. ``main`` and the ``run_*`` functions take a
``device`` keyword for callers that want the CPU.

Multi-GPU runs take one process per GPU, ``--mesh data,spatial,disp``
processes in all, laid out by ``parallel.make_mesh``. Training (train,
loop-train) splits the global batch ``--batchSize`` over the data axis and
every volume over H (spatial) and D (disp); the eval modes (test, val-30,
cross-val) run each frame's forward over a ``1,S,P`` mesh:

    torchrun --nproc_per_node D*S*P -m msnets_tpu_torch.cli --mode train \
        --mesh D,S,P ...
    torchrun --nproc_per_node S*P -m msnets_tpu_torch.cli --mode test \
        --mesh 1,S,P ...
    python -m msnets_tpu_torch.cli --mesh D,S,P --coordinator host:port \
        --num_hosts D*S*P --host_id i ...    # one command per rank i

With ``--coordinator``, ``--num_hosts`` and ``--host_id`` are the world size
and this process's rank. The training pipeline is then sharded over the
data axis: the ranks of one data index read the same samples.
``--quant_eval 1`` runs the eval modes in int8 (``--quant_mode dynamic``
or ``static``, ``--quant_scope all`` or ``stem``); an eval mode with a data
size above 1 raises ``ValueError``.
``--resume`` takes the port's ``.tar``, a reference ``.tar`` or the JAX
package's ``.msgpack``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from .config import (Config, DataConfig, EvalConfig, MatchingConfig,
                     MeshConfig, ModelConfig, TrainConfig)
from .runtime import DeviceLike

EVAL_MODES = ("test", "val-30", "cross-val")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MS-Nets on PyTorch/CUDA")
    p.add_argument("--crop_height", type=int, default=256)
    p.add_argument("--crop_width", type=int, default=512)
    p.add_argument("--max_disp", type=int, default=192)
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--batchSize", type=int, default=1)
    p.add_argument("--ckpt_every_steps", type=int, default=0,
                   help="mid-epoch checkpoint every N steps (0 off); resuming "
                        "such a checkpoint continues inside the epoch at the "
                        "next batch")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="micro-batches per step (gradient accumulation); BN "
                        "batch statistics are computed per micro-batch, in "
                        "order. MS-PSMNet with batch >= 2 and no explicit "
                        "--remat/--grad_accum defaults to no remat and "
                        "micro-batches of one (grad_accum=batch; a log line "
                        "says so)")
    p.add_argument("--log_summary_step", type=int, default=200)
    p.add_argument("--nEpochs", type=int, default=400)
    p.add_argument("--startEpoch", type=int, default=0)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--kitti2012", type=int, default=0)
    p.add_argument("--kitti2015", type=int, default=0)
    p.add_argument("--eth3d", type=int, default=0)
    p.add_argument("--middlebury", type=int, default=0)
    p.add_argument("--data_path", type=str, default="")
    p.add_argument("--training_list", type=str,
                   default="lists/sceneflow_train.list")
    p.add_argument("--test_list", type=str,
                   default="lists/sceneflow_test_select.list")
    p.add_argument("--checkpoint_dir", type=str, default="./checkpoints")
    p.add_argument("--train_logdir", type=str, default="./logs/tmp")
    p.add_argument("--model_name", type=str, default="MS-GCNet")
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "loop-train", "test", "val-30",
                            "cross-val", "eval-badx"])
    p.add_argument("--resultDir", type=str, default="./results")
    p.add_argument("--threshold", type=float, default=3.0)
    p.add_argument("--sf_frames", type=str, default="frames_finalpass")
    p.add_argument("--cbmv_F", type=int, default=8, choices=[8, 16],
                   help="8 = left-only features, 16 = left+right")
    p.add_argument("--mesh", type=str, default="",
                   help="multi-device layout data,spatial,disp, one process "
                        "per GPU, D*S*P in all: training splits the global "
                        "--batchSize over D and every volume over H (S) and "
                        "D (P); the eval modes take 1,S,P")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--num_hosts", type=int, default=1,
                   help="input-pipeline shard count (strided, full-coverage); "
                        "with --coordinator the number of processes")
    p.add_argument("--host_id", type=int, default=0)
    p.add_argument("--coordinator", type=str, default="",
                   help="torch.distributed rendezvous address host:port; "
                        "when set, num_hosts/host_id are the world size and "
                        "this process's rank (num_hosts defaults to the "
                        "--mesh size, data x spatial x disp)")
    p.add_argument("--remat", dest="remat", action="store_true",
                   help="recompute BN'd stages in the backward (see "
                        "TrainConfig.remat)")
    p.add_argument("--no_remat", dest="remat", action="store_false")
    p.add_argument("--remat_scope", type=str, default="all",
                   choices=["all", "hourglass"],
                   help="MS-PSMNet remat scope: 'all' (dres, classifiers and "
                        "hourglass stages) or 'hourglass' (hourglass stages "
                        "only)")
    p.add_argument("--quant_eval", type=int, default=0,
                   help="int8 eval of the stem and encoder convs "
                        "(models/quant.py). Coverage follows the JAX "
                        "package's layouts and the volume's shape: the "
                        "packed stride-1 convs, and stride-2 convs reading "
                        "the packed layout or above the >=1M-voxel "
                        "even-dims gate; the others stay in the compute "
                        "dtype")
    p.add_argument("--quant_scope", type=str, default="all",
                   choices=["all", "stem"],
                   help="which convs --quant_eval covers (MS-GCNet): 'all' "
                        "= stem conv2 + encoder block entries; 'stem' = "
                        "conv2 only")
    p.add_argument("--quant_mode", type=str, default="dynamic",
                   choices=["dynamic", "static"],
                   help="activation-scale regime for --quant_eval: 'dynamic'"
                        " = per-sample max-abs pass; 'static' = fixed"
                        " per-layer scales from a calibration forward on the"
                        " first frame of each new shape (out-of-range values"
                        " saturate at +-127)")
    p.add_argument("--features", type=str, default="ms",
                   choices=["ms", "raw"],
                   help="feature stage: 'ms' = matching-space volume (the "
                        "paper); 'raw' = 2-channel raw-intensity volume "
                        "[L(x), R(x-d)], the no-matching ablation baseline")
    # None -> the model-dependent default of args_to_config
    p.set_defaults(remat=None)
    return p


def args_to_config(a) -> Config:
    from .models import model_class
    seed = a.seed if a.seed > 0 else int(time.time()) % (2 ** 31)
    remat = a.remat if a.remat is not None else (
        a.model_name == "MS-PSMNet" or TrainConfig.remat)
    grad_accum = a.grad_accum
    if (a.model_name == "MS-PSMNet" and a.remat is None
            and a.grad_accum == 1 and a.batchSize >= 2):
        # the JAX package's MS-PSMNet default at batch >= 2: no remat, the
        # batch as batchSize sequential micro-batches of one (activations
        # of one pair, no recompute); BN statistics thread through the
        # micro-batches in order. Explicit --remat/--no_remat or
        # --grad_accum override.
        remat, grad_accum = False, a.batchSize
        print(f"[**] MS-PSMNet default engaged: no-remat + micro-batch-1 "
              f"accumulation (grad_accum={a.batchSize}; BN stats per "
              f"sample, a deviation from the reference's full-batch BN; "
              f"override with --remat or --grad_accum 1)")
    matching = MatchingConfig(sf_frames_type=a.sf_frames,
                              num_channels=a.cbmv_F,
                              features_mode=getattr(a, "features", "ms"))
    return Config(
        matching=matching,
        model=ModelConfig(name=a.model_name, max_disp=a.max_disp,
                          in_channels=model_class(
                              a.model_name).STAGE.channels(matching),
                          compute_dtype=a.compute_dtype,
                          quant_eval=bool(a.quant_eval),
                          quant_mode=a.quant_mode,
                          quant_scope=a.quant_scope),
        train=TrainConfig(crop_height=a.crop_height, crop_width=a.crop_width,
                          batch_size=a.batchSize, lr=a.lr,
                          epochs=a.nEpochs, start_epoch=a.startEpoch,
                          seed=seed, num_workers=a.threads,
                          log_summary_step=a.log_summary_step,
                          checkpoint_dir=a.checkpoint_dir,
                          train_logdir=a.train_logdir, resume=a.resume,
                          remat=remat, remat_scope=a.remat_scope,
                          grad_accum=grad_accum,
                          num_hosts=a.num_hosts, host_id=a.host_id,
                          ckpt_every_steps=a.ckpt_every_steps),
        data=DataConfig(data_path=a.data_path, training_list=a.training_list,
                        test_list=a.test_list,
                        kitti2012=bool(a.kitti2012),
                        kitti2015=bool(a.kitti2015),
                        eth3d=bool(a.eth3d), middlebury=bool(a.middlebury)),
        eval=EvalConfig(result_dir=a.resultDir, threshold=a.threshold),
        mode=a.mode,
    )


def parse_mesh(arg: str):
    """``--mesh data,spatial,disp`` as a ``MeshConfig``; None when unset."""
    if not arg:
        return None
    try:
        dims = [int(x) for x in arg.split(",")]
    except ValueError:
        dims = []
    if len(dims) != 3 or min(dims) < 1:
        raise ValueError(f"--mesh {arg!r}: want data,spatial,disp, three "
                         "positive integers")
    return MeshConfig(*dims)


def _silent(*_a, **_k) -> None:
    pass


def run_train(cfg: Config, device: DeviceLike = None, log=print, mesh=None):
    """Train ``cfg.train.epochs`` epochs after ``cfg.train.start_epoch``,
    resuming ``cfg.train.resume`` when it is a file (inside its epoch when
    it is a step checkpoint); returns the Trainer.

    With a ``mesh`` (``parallel.make_mesh``) this process is one rank of
    the step over it: it takes rank 0's seed, feeds ``batch_size // data``
    samples a step from the ``TrainPipeline`` shard of its data index (the
    mesh's data size and this rank's index on it, in place of
    ``num_hosts`` and ``host_id``), and only rank 0 logs, writes summaries
    and writes checkpoints."""
    from .data.pipeline import TrainPipeline
    from .engine import Trainer
    from .parallel import mesh as pm
    from .utils import summary as S

    # every rank must shard the same permutation: rank 0's seed (the
    # default seed comes from each process's clock)
    seed = pm.broadcast_int(cfg.train.seed, mesh.group if mesh else None)
    shard = {} if mesh is None else dict(num_hosts=mesh.size("data"),
                                         host_id=mesh.index("data"))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, seed=seed, **shard))
    t = cfg.train
    tr = Trainer(cfg, device=device, seed=t.seed, mesh=mesh)
    if tr.rank != 0:
        log = _silent
    resume_epoch, resume_iter = 0, 0
    if t.resume and os.path.isfile(t.resume):
        log(f"[***] resuming from {t.resume}")
        meta = tr.resume(t.resume)
        if "iteration" in meta:          # step checkpoint: resume inside
            resume_epoch = int(meta["epoch"])          # that epoch
            resume_iter = int(meta["iteration"])
            log(f"[***] mid-epoch resume: epoch {resume_epoch} "
                f"batch {resume_iter}")

    pipe = TrainPipeline(cfg.data, cfg.matching, t.crop_height, t.crop_width,
                         cfg.model.max_disp, t.batch_size // tr.data,
                         seed=t.seed,
                         num_threads=t.num_workers, num_hosts=t.num_hosts,
                         host_id=t.host_id)
    # exact per-epoch step counts: steps_per_epoch() is only an upper bound
    # when geometries mix (partial buckets drop per geometry)
    sched_len: dict = {}

    def epoch_len(e: int) -> int:
        if e not in sched_len:
            sched_len[e] = len(pipe.batch_schedule(e))
        return sched_len[e]

    def global_step(epoch: int, iteration: int) -> int:
        return sum(epoch_len(e) for e in range(1, epoch)) + iteration

    writer = None
    if t.train_logdir and tr.rank == 0:
        try:
            writer = S.TrainSummaryWriter(t.train_logdir)
        except ImportError as e:            # tensorboardX is optional
            log(f"[warn] no summary writer: {e}")
    run_log = {"loss": 0.0, "epe": 0.0, "n": 0}

    def log_fn(epoch, iteration, metrics, sec_per_step, trainer, disp, batch):
        gstep = global_step(epoch, iteration)
        log(S.console_line(epoch, iteration, epoch_len(epoch), gstep, metrics,
                           sec_per_step, S.process_mem_mb()))
        sys.stdout.flush()
        run_log["loss"] += metrics["loss"]
        run_log["epe"] += metrics["epe"]
        run_log["n"] += 1
        ls = t.log_summary_step
        if writer is not None and iteration % ls == ls - 1:
            n = max(run_log["n"], 1)
            writer.scalars(gstep, run_log["loss"] / n, run_log["epe"] / n)
            # per-matcher argmin feature-quality probe (main_msnet.py:443-458)
            probe = trainer.matcher_probe_fn(
                batch["board_h"], batch["board_w_left"],
                batch["board_w_right"])(batch["iml"], batch["imr"])
            # KITTI colours disparities with the KT15 false-colour map
            # instead of jet (main_msnet.py:246-320)
            writer.images(gstep, batch["left_rgb"], batch["right_rgb"],
                          disp.float().cpu().numpy(), batch["disp"],
                          matcher_argmin=S.matcher_argmin_from_probe(
                              probe.cpu().numpy()),
                          kt15_color=bool(cfg.data.kitti2012
                                          or cfg.data.kitti2015))
            run_log.update(loss=0.0, epe=0.0, n=0)

    avg = {}
    first, last = 1 + t.start_epoch, t.start_epoch + t.epochs
    if resume_iter and first <= resume_epoch <= last:
        first = resume_epoch            # re-enter the interrupted epoch; the
                                        # last epoch stays where it was
    done = False
    try:
        for epoch in range(first, last + 1):
            log(f"[**] training epoch {epoch}/{last}")
            si = resume_iter if epoch == resume_epoch else 0
            avg = tr.train_epoch(pipe, epoch, log_fn=log_fn,
                                 start_iteration=si)
            log("===> Epoch {} Complete: Avg. Loss: {:.4f}, Avg. EPE: {:.4f}, "
                "Accu3: {:.4f}".format(epoch, avg["loss"], avg["epe"],
                                       avg["accu3"]))
            tr.maybe_save(epoch, avg)
        tr.maybe_save(last, avg, final=True)
        done = True
    finally:
        # drain the background writes even on a crash: the newest
        # model_step_* files are what a restart resumes from (no barrier
        # then: the other ranks may be gone)
        try:
            tr.finish_checkpoints(barrier=done)
        except Exception as e:          # never mask the original error
            log(f"[warn] checkpoint drain failed: {e}")
    if writer is not None:
        writer.close()
    return tr


def run_loop_train(cfg: Config, device: DeviceLike = None, log=print,
                   mesh=None):
    """Epoch-granular restarts (do_main_msnet.sh:143-192): each epoch
    resumes the previous epoch's checkpoint file (over one mesh)."""
    from .engine.checkpoint import ckpt_path
    e0, ne = cfg.train.start_epoch, cfg.train.epochs
    resume = cfg.train.resume
    for epoch in range(e0, e0 + ne):
        c = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, start_epoch=epoch, epochs=1, resume=resume))
        run_train(c, device=device, log=log, mesh=mesh)
        resume = ckpt_path(cfg.train.checkpoint_dir, cfg.model.name, epoch + 1)


def run_test(cfg: Config, device: DeviceLike = None, log=print, mesh=None):
    """The evaluator on the weights of ``cfg.train.resume``, over ``mesh``
    (a ``parallel.Mesh``) when one is given."""
    from .engine import Evaluator, Trainer
    if not cfg.train.resume:
        raise ValueError("test mode needs --resume checkpoint")
    tr = Trainer(cfg, device=device, seed=0)
    tr.resume(cfg.train.resume)
    ev = Evaluator(cfg, tr.model.state_dict(), device=device, mesh=mesh)
    return ev.run(log=log)


def launch_world(a, mesh) -> int:
    """The number of processes this command was started among: with
    ``--coordinator``, ``--num_hosts`` (the ``--mesh`` size when unset);
    under torchrun, ``WORLD_SIZE``; else 1."""
    if a.coordinator:
        return a.num_hosts if a.num_hosts > 1 else (
            mesh.num_devices if mesh else 1)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return 1


def main(argv=None, device: DeviceLike = None):
    a = build_parser().parse_args(argv)
    given = parse_mesh(a.mesh)
    world = launch_world(a, given)
    mesh = given or MeshConfig(data=world)
    if mesh.num_devices != world:
        n = mesh.num_devices
        raise ValueError(
            f"--mesh {a.mesh} wants {n} processes, but this one was "
            f"started among {world}. Start {n}: torchrun "
            f"--nproc_per_node {n} -m msnets_tpu_torch.cli --mesh "
            f"{a.mesh} ..., or one command per rank i with --coordinator "
            f"host:port --num_hosts {n} --host_id i")
    if mesh.data > 1 and a.mode in EVAL_MODES:
        raise ValueError(
            f"--mode {a.mode} takes one frame at a time: a data axis of "
            f"{mesh.data} has nothing to split; split the frame with --mesh "
            f"1,S,P, or run it as one process")
    from .parallel import mesh as pm
    world, rank = pm.init_distributed(a.coordinator or None, world,
                                      a.host_id, device=device)
    import torch.distributed as dist
    on = dist.is_initialized()
    try:
        # every rank makes the mesh's groups, in the same order
        ranks = pm.make_mesh((mesh.data, mesh.spatial, mesh.disp)) if on \
            else None
        cfg = dataclasses.replace(args_to_config(a), mesh=mesh)
        if rank == 0:
            print(f"[***] mode={cfg.mode} model={cfg.model.name} "
                  f"dataset={cfg.data.dataset} ranks={world}")
        if cfg.mode == "train":
            run_train(cfg, device=device, mesh=ranks)
        elif cfg.mode == "loop-train":
            run_loop_train(cfg, device=device, mesh=ranks)
        elif cfg.mode in EVAL_MODES:
            run_test(cfg, device=device, mesh=ranks)
        elif cfg.mode == "eval-badx":
            from .engine import eval_bad_x
            eval_bad_x(cfg)
        if rank == 0:
            print(f"[***] {cfg.mode} finished")
    finally:
        if on:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
