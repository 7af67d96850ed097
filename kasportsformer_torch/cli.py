"""Command-line interface (port of the `serve` subcommand of
`kasportsformer_tpu/cli.py`): `python -m kasportsformer_torch serve`.

It loads reference `.pth` checkpoints. Native checkpoints, and the other
subcommands, wait for their slices of the port.
"""

from __future__ import annotations

import argparse
import sys


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
    p_serve = sub.add_parser("serve", help="HTTP lifting service")
    p_serve.add_argument("--config-path", required=True)
    p_serve.add_argument("--checkpoint", required=True,
                         help="reference .pth checkpoint")
    p_serve.add_argument("--host", default="127.0.0.1")
    p_serve.add_argument("--port", type=int, default=8000)
    p_serve.add_argument("--batch-size", type=int, default=128,
                         help="clips per forward (the TTA doubles them)")
    p_serve.add_argument("--device", default="cuda",
                         help="'cuda' (default) or 'cpu'")
    p_serve.set_defaults(fn=cmd_serve)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
