"""CLI entry point: ``python -m languagegroundedsemseg_torch.cli.main --model
Res16UNet34C --dataset Scannet200Voxelization2cmDataset ...``

Counterpart of ``languagegroundedsemseg_tpu/cli/main.py`` (:19-61). The flag
surface mirrors the reference's main.py (reference main.py:55-201) through
``config.get_config``; trainer-mode selection, resume discovery, and
train/test dispatch match its behavior: instance datasets go to
``insseg.trainer.InssegTrainer`` (fit to ``max_iter`` steps, then
validate), every other mode to ``train.trainer.Trainer``. Runs on the
card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import logging
import os
import sys

from languagegroundedsemseg_torch.config import get_config
from languagegroundedsemseg_torch.utils.host_alloc import tune as _tune_host_alloc


def main(argv=None, device="cuda"):
    _tune_host_alloc()
    config = get_config(argv)
    logging.basicConfig(
        level=logging.INFO,
        format=f"%(asctime)s [{os.uname().nodename}] %(message)s",
    )

    from languagegroundedsemseg_torch.train.trainer import Trainer, select_mode

    mode = select_mode(config)
    logging.info("mode=%s model=%s dataset=%s", mode, config.model, config.dataset)

    if mode == "insseg":
        # Downstream instance segmentation (reference ddp_main.py entry):
        # dataset registry classes with "Instance" route here.
        from languagegroundedsemseg_torch.insseg.dataset import load_instance_dataset
        from languagegroundedsemseg_torch.insseg.trainer import InssegTrainer

        trainer = InssegTrainer(config, dataset_cls=load_instance_dataset(config.dataset),
                                device=device)
        try:
            if config.is_train:
                trainer.fit(max_steps=int(config.max_iter))
            metrics = trainer.validate()
        finally:
            trainer.close()
        logging.info("final metrics: %s", metrics)
        return metrics

    trainer = Trainer(config, device=device)
    try:
        if config.is_train:
            trainer.fit()
        metrics = trainer.test()
    finally:
        trainer.close()
    logging.info("final metrics: %s", metrics)
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
