"""Training entry point of the port.

    python -m encodec_pytorch_tpu_torch.train_cli [--device cuda|cpu] [--config NAME] [key.path=value ...]

The config is one of the port's default sets (``config.CONFIGS``), with
dot-path overrides, e.g. ``datasets.train_csv_path=data/train.csv
common.max_epoch=1``:

- ``config`` (the default, copied from
  ``encodec_pytorch_tpu/configs/config.yaml``): 24 kHz mono from a CSV of
  wavs, batch 12 x 72000 samples, bf16, the discriminator's eligible convs on
  kernel K4;
- ``config_48k_stereo`` (``configs/config_48k_stereo.yaml``): 48 kHz stereo,
  batch 32 x 48000, 1 s normalized segments, the discriminator's F-stride-2
  convs on kernel K5;
- ``config_mono_nq2`` (``configs/config_mono_nq2.yaml``): 24 kHz mono at n_q
  2 from the multi-channel scene dataset under ``datasets.data_root`` (one
  random channel and 1 s window of a scene file an item), batch 16 x 24000,
  f32, a discriminator update on half the steps;
- ``config_mono_nq2_resume`` (``configs/config_mono_nq2_resume.yaml``): the
  same, resuming from ``checkpoint.checkpoint_path``.

It runs on the CUDA card unless ``--device cpu`` is given, and refuses to run
without a card otherwise. It logs the losses and the milliseconds per step
(and to tensorboard under ``{checkpoint.save_folder}/runs`` where
``tensorboardX`` imports), runs the test loop every ``common.test_interval``
epochs and writes the whole training state every ``common.save_interval``
epochs under ``checkpoint.save_location``; ``checkpoint.resume=true
checkpoint.checkpoint_path=<file>`` resumes from one. On SIGTERM it writes a
``_preempt`` checkpoint at the next step boundary and exits with code 143.
"""

import argparse
import logging
import sys

import torch

from .config import CONFIGS, load_config


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--device', default='cuda', help='cuda (default) or cpu')
    parser.add_argument('--config', default='config', choices=sorted(CONFIGS),
                        help='default set: config (24 kHz, the default), config_48k_stereo, '
                             'config_mono_nq2 or config_mono_nq2_resume')
    parser.add_argument('overrides', nargs='*', help='dot-path overrides: key.path=value')
    args = parser.parse_args(argv)
    if args.device.startswith('cuda') and not torch.cuda.is_available():
        parser.error('no CUDA device is available; pass --device cpu to train on the CPU')
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format='%(asctime)s: %(message)s')
    logging.getLogger('encodec_pytorch_tpu_torch').setLevel(logging.INFO)

    from .train.trainer import Trainer
    trainer = Trainer(load_config(args.overrides, args.config), device=args.device)
    trainer.run()
    return trainer


if __name__ == '__main__':
    main(sys.argv[1:])
