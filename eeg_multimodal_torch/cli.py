"""Command-line interface of the port: ``python -m eeg_multimodal_torch.cli``.

The JAX package's ``cli.py`` with the same ten subcommands, arguments and
defaults, each calling the port's backend:

  demo      the DP-MLD demo run                      (ref demo.py)
  train     TrainAndTest with explicit knobs         (ref base_train.py:67)
  legacy    the train.py-style metric trainer        (ref train.py:29-47)
  compare   run an experiment driver's grid          (ref compare_*.py)
  sweep     the batched eps x seed sweep
  embed     build the embedding tree                 (ref get_embedding.py:137)
  process   raw task txt -> processed CSVs           (ref process.py, data.sh)
  pretrain  MLM pretraining + the DP-MLD fine-tune   (train/mlm.py)
  distill   the train split's act CLIP embeddings from the real test-side
            array (train/distill.py)
  predict   evaluate a trained checkpoint; per-row predictions CSV

Every subcommand that computes also takes ``--device`` (default: the card;
``--device cpu`` runs on the CPU). Backends are imported inside ``main``,
so that ``--help`` imports no model code.
"""
from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    """The parser of every subcommand (cli.py:24-147 there, and
    ``--device``)."""
    p = argparse.ArgumentParser(prog="eeg_multimodal_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_device(sp):
        sp.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' for the CPU)")

    def add_common(sp):
        sp.add_argument("--data_root", default=".")
        sp.add_argument("--batch_size", "-bs", type=int, default=8)
        sp.add_argument("--learning_rate", "-lr", type=float, default=1e-6)
        sp.add_argument("--epochs", "-n", type=int, default=50)
        sp.add_argument("--dtype", default="bfloat16")
        add_device(sp)

    def add_model(sp):
        sp.add_argument("--multimodal_type", default="ti", choices=["ti", "tt", "it", "ii"])
        sp.add_argument("--dp_mode", default="lapacian_dropout")
        sp.add_argument("--eeg_model", default="bert")
        sp.add_argument("--eeg_model_coef", default="bert-base-uncased")
        sp.add_argument("--act_model", default="clip")
        sp.add_argument("--act_model_coef", default="ViT-B/32")
        sp.add_argument("--cross_atn_type", default="double_stream")
        sp.add_argument("--epsilon", "-e", type=float, default=0.1)

    sp = sub.add_parser("demo")
    add_common(sp)
    sp.add_argument("--epsilon", "-e", type=float, default=0.1)

    sp = sub.add_parser("train")
    add_common(sp)
    sp.add_argument("--train_type", default="custom")
    sp.add_argument("--path_suffix", default="run/")
    add_model(sp)

    sp = sub.add_parser("legacy")  # ref train.py:29-47
    sp.add_argument("--exp", default="test")
    sp.add_argument("--name", default="test")
    sp.add_argument("--batch_size", "-bs", type=int, default=8)
    sp.add_argument("--data_name", "-d", default="EEG")
    sp.add_argument("--eps", "-e", type=float, default=2.0)
    sp.add_argument("--n_class", "-c", type=int, default=2)
    sp.add_argument("--n_dp", "-nd", type=int, default=1)
    sp.add_argument("--n_para", "-np", type=int, default=1)
    sp.add_argument("--n_eval", "-ne", type=int, default=5)
    sp.add_argument("--n_epochs", type=int, default=50)
    sp.add_argument("--interval", type=int, default=1)
    sp.add_argument("--metrics", "-m", default="Accuracy")
    sp.add_argument("--data_root", default=".")
    add_device(sp)

    sp = sub.add_parser("compare")
    add_common(sp)
    sp.add_argument("driver", choices=["modal", "privacy_budget", "private_scheme",
                                       "model_ini_weight", "cross_modal_type"])

    sp = sub.add_parser("sweep")
    add_common(sp)
    sp.add_argument("--epsilons", default="0.1,1,3,5,10")
    sp.add_argument("--seeds", default="980616")
    sp.add_argument("--log_root", default="logs/sweep")

    sp = sub.add_parser("embed")
    sp.add_argument("--data_root", default=".")
    sp.add_argument("--modals", default="act,EEG")
    sp.add_argument("--splits", default="train,test")
    sp.add_argument("--vocab_txt", action="append", default=[], metavar="COEF=PATH",
                    help="HF vocab.txt for a coef, e.g. bert-base-cased=/w/vocab.txt "
                         "(exact token ids; otherwise uncased uses the packaged "
                         "recovered vocab and cased the synthetic one)")
    sp.add_argument("--clip_weights", default=None)
    sp.add_argument("--resnet_weights", default=None)
    add_device(sp)

    sp = sub.add_parser("process")
    sp.add_argument("tasks", nargs="+")
    sp.add_argument("--out", default="data/processed")

    sp = sub.add_parser("distill")
    sp.add_argument("--data_root", default=".",
                    help="tree with data/processed CSVs + txt/EEG-img embedding pickles "
                         "(copied into the output tree)")
    sp.add_argument("--out", required=True, help="output data root")
    sp.add_argument("--real_test_pickle", required=True,
                    help="the REAL CLIP array of the test act rows, e.g. "
                         "<ref>/feature/action/test_clip_v2.pickle")
    sp.add_argument("--steps", type=int, default=4000)
    sp.add_argument("--fit_fraction", type=float, default=1.0,
                    help="fit the deployed distiller on only this random fraction of the "
                         "test pairs (leakage control)")
    add_device(sp)

    sp = sub.add_parser("pretrain")
    add_common(sp)
    sp.set_defaults(epochs=120)
    sp.add_argument("--out", default="mlm_run")
    sp.add_argument("--mlm_steps", type=int, default=8000)
    sp.add_argument("--mlm_batch", type=int, default=128)
    sp.add_argument("--mlm_lr", type=float, default=1e-4)
    sp.add_argument("--epsilon", "-e", type=float, default=0.1)
    sp.add_argument("--bert_ckpt", default=None,
                    help="skip MLM; load the encoder from this save_pytree file")
    sp.add_argument("--row_reg_weight", type=float, default=0.0,
                    help="joint row-value-regression pretext weight")
    sp.add_argument("--aug_factor", type=int, default=0,
                    help="jittered corpus copies per row (0 = off)")
    sp.add_argument("--aug_jitter", type=float, default=0.03,
                    help="augmentation noise as a fraction of column std")
    sp.add_argument("--whole_word", action="store_true",
                    help="whole-number (word-level) corruption")
    sp.add_argument("--clip_weight", type=float, default=0.0,
                    help="cross-modal act-CLIP distillation pretext weight")
    sp.add_argument("--dp_mode", default="lapacian_dropout",
                    help="fine-tune regime (e.g. NDP)")

    sp = sub.add_parser("predict")
    add_common(sp)
    sp.add_argument("checkpoint")
    add_model(sp)
    sp.add_argument("--split", default="test")
    sp.add_argument("--n_eval", type=int, default=1)
    sp.add_argument("--out_csv", default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.cmd == "process":
        from .data.process import process

        process(args.tasks, args.out)
        return 0

    if args.cmd == "distill":
        from .train.distill import DistillConfig, build_distilled_act_tree

        build_distilled_act_tree(
            args.data_root, args.out, args.real_test_pickle,
            cfg=DistillConfig(steps=args.steps, fit_fraction=args.fit_fraction),
            device=args.device)
        return 0

    if args.cmd == "pretrain":
        from .train.mlm import pretrain_finetune_mlm

        result = pretrain_finetune_mlm(
            args.data_root, args.out, mlm_steps=args.mlm_steps, mlm_batch=args.mlm_batch,
            mlm_lr=args.mlm_lr, epsilon=args.epsilon, epochs=args.epochs,
            batch_size=args.batch_size, learning_rate=args.learning_rate,
            compute_dtype=args.dtype, bert_ckpt=args.bert_ckpt,
            row_reg_weight=args.row_reg_weight, aug_factor=args.aug_factor,
            aug_jitter=args.aug_jitter, whole_word=args.whole_word,
            clip_weight=args.clip_weight, dp_mode=args.dp_mode, device=args.device)
        best = result["best"]
        if best:
            print(f"BEST epoch {best['epoch']}: acc {best['test_acc']:.3f} "
                  f"f1 {result['f1_best']:.3f}")
        return 0

    if args.cmd == "embed":
        from .data.embedding import GetEmbedding

        job = GetEmbedding(
            args.modals.split(","), args.splits.split(","), data_root=args.data_root,
            vocab_txts=dict(v.split("=", 1) for v in args.vocab_txt),
            clip_weights=args.clip_weights, resnet_weights=args.resnet_weights,
            device=args.device)
        job.run([["clip", "ViT-B/16"], ["clip", "ViT-B/32"], ["resnet", "resnet34"]],
                [["bert", "bert-base-uncased"], ["bert", "bert-base-cased"]])
        return 0

    if args.cmd == "legacy":
        from .data import datasets as D
        from .models import fusion
        from .train.legacy import MetricTrainConfig, MetricTrainer

        cfg = MetricTrainConfig(
            exp=args.exp, name=args.name, batch_size=args.batch_size, eps=args.eps,
            n_class=args.n_class, n_dp=args.n_dp, n_para=args.n_para, n_eval=args.n_eval,
            n_epochs=args.n_epochs, interval=args.interval, metrics=args.metrics)
        # the legacy layout: feature/{train,test}_EEG.csv and pickles (data.py)
        root = args.data_root
        tok_tr = D.load_bert_pickle(os.path.join(root, "feature/EEG/train_bert.pickle"))
        tok_te = D.load_bert_pickle(os.path.join(root, "feature/EEG/test_bert.pickle"))
        emb_tr = D.load_embedding_pickle(os.path.join(root, "feature/action/train_clip_v2.pickle"))
        emb_te = D.load_embedding_pickle(os.path.join(root, "feature/action/test_clip_v2.pickle"))
        _, lab_tr = D.load_eeg_feature_csv(os.path.join(root, "feature/train_EEG.csv"))
        _, lab_te = D.load_eeg_feature_csv(os.path.join(root, "feature/test_EEG.csv"))
        train = D.build_pairing("ti", lab_tr, eeg_txt=tok_tr, act_img=emb_tr)
        test = D.build_pairing("ti", lab_te, eeg_txt=tok_te, act_img=emb_te)
        trainer = MetricTrainer(fusion.config_for("ti", "lapacian_dropout"), cfg,
                                device=args.device)
        trainer.fit(train, test, base_path=f"experiment/{cfg.exp}/{cfg.name}/")
        return 0

    from .train.api import TrainAndTest

    job = TrainAndTest(batch_size=args.batch_size, learning_rate=args.learning_rate,
                       epochs=args.epochs, data_root=args.data_root, compute_dtype=args.dtype,
                       device=args.device)

    if args.cmd == "predict":
        out = job.predict(
            args.checkpoint, args.multimodal_type, args.dp_mode, args.eeg_model,
            args.eeg_model_coef, args.act_model, args.act_model_coef, args.cross_atn_type,
            args.epsilon, split=args.split, n_eval=args.n_eval, out_csv=args.out_csv)
        print(f"{args.split}: loss {out['loss']:.4f} acc {out['accuracy']:.3f} "
              f"f1 {out['f1']:.3f}" + (f" -> {args.out_csv}" if args.out_csv else ""))
        return 0

    if args.cmd == "demo":
        from .experiments.drivers import Demo

        Demo(python_job=job).demo()
        return 0

    if args.cmd == "train":
        job.train(args.train_type, args.path_suffix, args.multimodal_type, args.dp_mode,
                  args.eeg_model, args.eeg_model_coef, args.act_model, args.act_model_coef,
                  args.cross_atn_type, args.epsilon)
        return 0

    if args.cmd == "compare":
        from .experiments import drivers as drv

        cls = {"modal": drv.CompareModal, "privacy_budget": drv.ComparePrivacyBudget,
               "private_scheme": drv.ComparePrivateScheme,
               "model_ini_weight": drv.CompareModelInitWeight,
               "cross_modal_type": drv.CompareCrossModalType}[args.driver]
        cls(python_job=job).run()
        return 0

    if args.cmd == "sweep":
        from .data.datasets import truncate_pair
        from .models import fusion
        from .train.sweep import SweepMember, SweepRunner
        from .train.trainer import TrainConfig

        members = [SweepMember(float(e), int(s)) for e in args.epsilons.split(",")
                   for s in args.seeds.split(",")]
        fc = fusion.config_for("ti", "lapacian_dropout", dtype="float32")
        tc = TrainConfig(batch_size=args.batch_size, learning_rate=args.learning_rate,
                         epochs=args.epochs, compute_dtype=args.dtype)
        train, test = truncate_pair(*(job._load_split(s, "ti", "bert", "bert-base-uncased",
                                                      "clip", "ViT-B/32")
                                      for s in ("train", "test")))
        SweepRunner(fc, tc, members, device=args.device).run(train, test,
                                                             log_root=args.log_root)
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
