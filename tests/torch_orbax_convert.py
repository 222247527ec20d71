"""Convert a checkpoint written by the JAX package (orbax trees and its
config.json) into a checkpoint of the PyTorch port.

    JAX_PLATFORMS=cpu python tests/torch_orbax_convert.py JAX_CKPT OUT

Reads the checkpoint with ``insmos_tpu.utils.checkpoint.load_checkpoint``,
takes its parameter and BatchNorm state trees as numpy arrays and writes
them, with the same configuration and step, through the port's
``utils.checkpoint.save_checkpoint_from_trees``; ``predict_mos --ckpt OUT``
then runs the JAX-trained weights. The JAX optimizer state (optax) is not
converted, so a converted checkpoint serves inference and ``train
--weights``, not ``train --checkpoint``. The port cannot import this file:
it imports jax. tests/test_torch_orbax.py holds it on a checkpoint the JAX
package saves in the test.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def convert(jax_ckpt: str, out: str) -> dict:
    """Writes the port checkpoint ``out`` from the JAX checkpoint
    ``jax_ckpt``. Returns its config, numpy trees and step."""
    import jax

    from insmos_tpu.utils.checkpoint import load_checkpoint
    from insmos_tpu_torch.config import Config
    from insmos_tpu_torch.utils.checkpoint import save_checkpoint_from_trees

    jcfg, params, state, _, step = load_checkpoint(jax_ckpt)
    cfg = Config.from_dict(jcfg.to_dict())
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    params, state = to_np(params), to_np(state)
    save_checkpoint_from_trees(out, cfg, params, state, step)
    return dict(cfg=cfg, params=params, state=state, step=step)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("jax_ckpt", help="checkpoint directory of the JAX package")
    ap.add_argument("out", help="port checkpoint directory to write")
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    res = convert(args.jax_ckpt, args.out)
    print(f"wrote {args.out}: step {res['step']}, experiment "
          f"{res['cfg'].experiment_id}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
