"""Command-line interface (port of the `train`, `evaluate` and `serve`
subcommands of `kasportsformer_tpu/cli.py`):
`python -m kasportsformer_torch <train|evaluate|serve> --config-path <yaml>`.

Every subcommand runs on `--device` (default cuda, which raises where CUDA is
absent; `--device cpu` runs the plain versions of the kernels). `train` with
`eval_only: true` in the config evaluates, as in the JAX package. The wandb
sink, `preprocess`, `bench`, `export`, `visualize` and the demo wait for
later slices of the port.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _load_train_checkpoint(config, model, log) -> dict:
    """Weights only (`checkpoint: true`, a reference `.pth` or a native
    directory) or a full resume (`resume: true` on a native directory:
    optimizer state, lr and scheduler state too). Returns the
    `Trainer.fit` keyword arguments."""
    from kasportsformer_torch.train import checkpoint as ckpt
    from kasportsformer_torch.train.loop import load_checkpoint_meta, resume_kwargs

    path = os.path.join(config.checkpoint_dir, config.checkpoint_file_name)
    if path.endswith(".pth") and os.path.exists(path):
        model.load_state_dict(ckpt.load_torch_checkpoint(path), strict=True)
        log.info(f"torch checkpoint loaded ({path})")
        return {}
    if os.path.isdir(path):
        payload = ckpt.restore_native(path)
        model.load_state_dict(payload["model"], strict=True)
        log.info(f"native checkpoint loaded ({path}), resume={config.resume}")
        if config.resume:
            return resume_kwargs(load_checkpoint_meta(path), payload["optimizer"])
        return {}
    raise FileNotFoundError(f"checkpoint path is wrong: {path}")


def cmd_train(args: argparse.Namespace) -> int:
    """Train on `--device` (≙ `train_and_evaluate_sp.py` / `_wp.py`)."""
    from kasportsformer_torch.config import load_config
    from kasportsformer_torch.data.clips import load_split
    from kasportsformer_torch.models import build_model
    from kasportsformer_torch.train.loop import Trainer
    from kasportsformer_torch.utils.common import get_logger, seed_everything

    config = load_config(args.config_path)
    if config.eval_only:
        return cmd_evaluate(args)
    seed_everything(config.seed)
    log = get_logger(config.logger_dir_path, config.logger_file_name)
    train_set = load_split(config.data_root, config.clip_set_name, "train")
    test_set = load_split(config.data_root, config.clip_set_name, "test")
    log.info(f"clips: train {len(train_set)}, test {len(test_set)}")
    model = build_model(config, device=args.device)
    log.info(f"model {config.model_name}: {model.parameter_count():,} params "
             f"on {args.device}")
    fit_kwargs = (_load_train_checkpoint(config, model, log)
                  if config.checkpoint else {})
    if config.use_wandb:
        log.warning("use_wandb: the wandb sink is not ported yet; metrics go "
                    "to the log only")
    Trainer(config, model, train_set, test_set, log=log).fit(**fit_kwargs)
    return 0


def cmd_evaluate(args: argparse.Namespace) -> int:
    """The eval protocol on a checkpoint: a reference `.pth` or a native
    directory (`--checkpoint`, else the config's evaluate_checkpoint_*).
    Prints the numeric results as one JSON line."""
    from kasportsformer_torch.config import load_config
    from kasportsformer_torch.data.clips import load_split
    from kasportsformer_torch.models import build_model
    from kasportsformer_torch.train import checkpoint as ckpt
    from kasportsformer_torch.train.evaluator import Evaluator, format_eval_report
    from kasportsformer_torch.utils.common import get_logger, seed_everything

    config = load_config(args.config_path)
    seed_everything(config.seed)
    log = get_logger(config.logger_dir_path, f"{config.config_name}_evaluate.log")
    test_set = load_split(config.data_root, config.clip_set_name, "test")
    model = build_model(config, device=args.device)
    path = getattr(args, "checkpoint", None) or os.path.join(
        config.evaluate_checkpoint_file_dir, config.evaluate_checkpoint_file)
    if path.endswith(".pth") and os.path.exists(path):
        sd = ckpt.load_torch_checkpoint(path)
    elif os.path.isdir(path):
        sd = ckpt.restore_native(path)["model"]
    else:
        raise FileNotFoundError(
            f"evaluation checkpoint is wrong, check your configuration: {path}")
    model.load_state_dict(sd, strict=True)
    log.info(f"model {config.model_name}: {model.parameter_count():,} params")
    result = Evaluator(model, test_set,
                       batch_size=config.eval_batch_size or config.batch_size,
                       flip=config.flip,
                       input_channel_number=config.input_channel_number).run()
    log.info("\n" + format_eval_report(result))
    print(json.dumps({k: v for k, v in result.items()
                      if isinstance(v, (int, float))}))
    return 0


def cmd_serve(args: argparse.Namespace) -> int:
    """HTTP lifting service on `--device` (default cuda; see serving.py)."""
    from kasportsformer_torch.config import load_config
    from kasportsformer_torch.models import build_model
    from kasportsformer_torch.serving import serve
    from kasportsformer_torch.train.checkpoint import load_torch_checkpoint

    config = load_config(args.config_path)
    model = build_model(config, device="cpu")
    model.load_state_dict(load_torch_checkpoint(args.checkpoint), strict=True)
    server = serve(model, host=args.host, port=args.port,
                   n_frames=config.n_frames, batch_size=args.batch_size,
                   flip=config.flip, model_name=config.model_name,
                   device=args.device)
    print(f"serving {config.model_name} on http://{args.host}:"
          f"{server.server_address[1]} ({args.device})", file=sys.stderr)
    try:
        server.serve_forever()
    finally:
        server.server_close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="kasportsformer_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    device_help = "'cuda' (default) or 'cpu'"
    p_train = sub.add_parser("train", help="train (and evaluate every epoch)")
    p_train.add_argument("--config-path", required=True)
    p_train.add_argument("--device", default="cuda", help=device_help)
    p_train.set_defaults(fn=cmd_train)
    p_eval = sub.add_parser("evaluate", help="the eval protocol on a checkpoint")
    p_eval.add_argument("--config-path", required=True)
    p_eval.add_argument("--checkpoint", default=None,
                        help="reference .pth or native checkpoint directory")
    p_eval.add_argument("--device", default="cuda", help=device_help)
    p_eval.set_defaults(fn=cmd_evaluate)
    p_serve = sub.add_parser("serve", help="HTTP lifting service")
    p_serve.add_argument("--config-path", required=True)
    p_serve.add_argument("--checkpoint", required=True,
                         help="reference .pth checkpoint")
    p_serve.add_argument("--host", default="127.0.0.1")
    p_serve.add_argument("--port", type=int, default=8000)
    p_serve.add_argument("--batch-size", type=int, default=128,
                         help="clips per forward (the TTA doubles them)")
    p_serve.add_argument("--device", default="cuda", help=device_help)
    p_serve.set_defaults(fn=cmd_serve)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
