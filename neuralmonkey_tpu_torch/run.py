"""Batch inference CLI (counterpart of ``neuralmonkey_tpu/run.py``).

Usage: python -m neuralmonkey_tpu_torch.run exp.ini data.ini [ckpt]

The data INI declares datasets (series and output files) under
``[main] test_datasets``. The checkpoint is an ``.npz`` file written by
either package; without one, the newest ``variables.data*`` of the
experiment's output directory is used. On a machine with an NVIDIA
card the model runs there, through the hand-written kernels.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .logging import log

from .config.configuration import Configuration
from .experiment import Experiment


def load_data_config(path: str) -> List:
    config = Configuration()
    config.add_argument("test_datasets", required=False, default=None)
    config.add_argument("eval_datasets", required=False, default=None)
    config.load_file(path)
    config.build_model()
    datasets = (getattr(config.model, "test_datasets", None)
                or getattr(config.model, "eval_datasets", None))
    if datasets is None:
        raise ValueError(
            f"Data config {path} must define [main] test_datasets")
    return datasets if isinstance(datasets, list) else [datasets]


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="neuralmonkey_tpu_torch.run",
        description="Run a trained model over datasets.")
    parser.add_argument("config", help="experiment INI file")
    parser.add_argument("datasets", help="data INI file")
    parser.add_argument("checkpoints", nargs="*",
                        help="checkpoint path (one; ensembles are not "
                             "ported yet)")
    args = parser.parse_args(argv)

    exp = Experiment(args.config)
    exp.build_model()
    exp.restore_variables(args.checkpoints)
    for dataset in load_data_config(args.datasets):
        exp.run_model(dataset, write_out=True)
    log("Done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
