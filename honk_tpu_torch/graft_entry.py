"""The single-device entry and the multi-device dry run (counterpart of ``__graft_entry__.py``).

- ``entry()`` returns ``(fn, example_args)``: the raw-audio -> logits
  forward of res8 at full width in float32 (``train.make_forward``: the MFCC
  kernel, then the res-stack kernel in its float32 mode, conv0 and the pool
  inside it), on
  weights drawn from a seeded generator (``init_weights``) and eight seeded
  utterances of noise, ``default_rng(0).standard_normal((8, 16000)) * 0.1``
  in float32 as the reference draws them. On the card, ``fn(*args)``
  launches the MFCC kernel once and the res stack once.
- ``dryrun_multichip`` is ``parallel.dryrun.dryrun_multichip``.

    python -m honk_tpu_torch.graft_entry [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import resolve_device, use_full_f32
from .parallel.dryrun import dryrun_multichip

__all__ = ["dryrun_multichip", "entry"]


def entry(device: str | torch.device | None = None):
    """``(fn, (model, audio))`` with ``fn(model, audio) -> (8, 12)`` logits, on ``device`` (cuda by default)."""
    from .models import find_config, find_model, init_weights
    from .train.steps import make_forward

    dev = resolve_device(device)
    use_full_f32()  # conv0 out of TF32: the reference's 2e-4 logit gate
    model = init_weights(find_model("res8")(find_config("res8")), torch.Generator().manual_seed(0)).to(dev)
    forward = make_forward()
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 16000)).astype(np.float32)) * 0.1

    def fn(model, audio):
        return forward(model, audio)

    return fn, (model, audio.to(dev))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="honk_tpu_torch.graft_entry", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    fn, args_ = entry(args.device)
    print("entry forward:", tuple(fn(*args_).shape))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
