"""Convert a JAX package checkpoint (Orbax) into the PyTorch port's layout.

    python scripts/torch_convert_orbax.py JAX_WEIGHTS PORT_WEIGHTS \
        [--name best|last|both] [--flagship] [--set key=value ...]

Restores ``JAX_WEIGHTS/FasterRCNNTrainer_{best,last}`` as the JAX package's
``utils/checkpoint.py:save_checkpoint`` wrote it (orbax's
``StandardCheckpointer``), maps its ``params`` and ``batch_stats`` onto the
port's ``FasterRCNN`` through ``utils/jax_weights.py:load_jax_variables``
and writes ``PORT_WEIGHTS/FasterRCNNTrainer_*/state.pt`` through the port's
``utils/checkpoint.py:save_checkpoint``.  The port's ``evaluate``,
``infer``, ``Predictor.from_checkpoint`` and ``train(pre_train=True)`` then
load it.

It carries the weights and the batch-norm statistics only: optax's AdamW
moments and ``MultiSteps`` accumulator have no place in the port's
optimiser state here, so the written state has a fresh optimiser and
counters at 0 (the reference's ``pre_train`` meaning).  ``--flagship`` and
``--set`` build the port's ``Config`` as its CLI does; it must describe the
model the JAX run trained (``fpn``, ``backbone``, ``num_classes``, ...).
The model is built on the CPU: the checkpoint holds host tensors either
way.

This is a script and not a module of the port because it imports orbax and
the JAX package, which the port's package never imports.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NAMES = {"best": "FasterRCNNTrainer_best", "last": "FasterRCNNTrainer_last"}


def restore_variables(jax_weights: str, name: str):
    """``(params, batch_stats)`` of a JAX package checkpoint as nested dicts
    of numpy arrays."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp

    full = os.path.abspath(os.path.join(jax_weights, name))
    if not os.path.isdir(full):
        raise FileNotFoundError(f"no JAX checkpoint {full}")
    tree = ocp.StandardCheckpointer().restore(full)
    as_np = lambda t: jax.tree.map(np.asarray, t)
    return as_np(tree["params"]), as_np(tree["batch_stats"])


def convert(jax_weights: str, port_weights: str, cfg, names=("best",)):
    """Convert each checkpoint of ``names`` (``"best"``, ``"last"``);
    returns the directories written."""
    from two_stage_object_detection_tpu_torch.nets.trainer import (
        create_train_state)
    from two_stage_object_detection_tpu_torch.utils import checkpoint as ckpt
    from two_stage_object_detection_tpu_torch.utils.jax_weights import (
        load_jax_variables)

    written = []
    for key in names:
        params, stats = restore_variables(jax_weights, NAMES[key])
        model, state = create_train_state(cfg, device="cpu")
        load_jax_variables(model, params, stats)
        written.append(ckpt.save_checkpoint(port_weights, state, NAMES[key]))
    return written


def main(argv=None) -> int:
    from two_stage_object_detection_tpu_torch.__main__ import _load_cfg

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("jax_weights", help="the JAX run's weights directory")
    ap.add_argument("port_weights", help="the port's weights directory")
    ap.add_argument("--name", choices=("best", "last", "both"),
                    default="both")
    ap.add_argument("--config", default=None)
    ap.add_argument("--flagship", action="store_true")
    ap.add_argument("--set", action="extend", nargs="+", metavar="KEY=VALUE")
    args = ap.parse_args(argv)
    names = ("best", "last") if args.name == "both" else (args.name,)
    names = [n for n in names if os.path.isdir(
        os.path.join(args.jax_weights, NAMES[n]))] or names
    for path in convert(args.jax_weights, args.port_weights,
                        _load_cfg(args), names):
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
