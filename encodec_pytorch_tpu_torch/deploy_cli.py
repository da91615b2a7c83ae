"""Write a self-contained ``torch.export`` serving artifact (``deploy.py``).

Port of ``encodec_pytorch_tpu/deploy_cli.py``: loads a model as the codec CLI
does (the ``MODELS`` registry and a released-layout or trainer checkpoint),
optionally folds weight norm, then exports encode/decode/roundtrip programs,
weights baked in, for the requested clip lengths × bandwidths into one zip.
The export runs on ``--device`` (``cuda`` by default; without a card pass
``--device cpu``); the artifact serves on either (``DeployedCodec.load``).

    python -m encodec_pytorch_tpu_torch.deploy_cli out.ecdz \\
        -m encodec_24khz -c ckpt.th --seconds 1 30 --bandwidths 6 24
"""

import argparse
import os
import sys

import torch

MODEL_NAMES = ('encodec_24khz', 'encodec_48khz', 'my_encodec', 'encodec_bw')


def get_parser():
    parser = argparse.ArgumentParser(
        'encodec-torch-deploy', description='Export a self-contained torch.export codec '
                                            'artifact.')
    parser.add_argument('output', help='Artifact path to write (.ecdz zip).')
    parser.add_argument('-m', '--model_name', default='encodec_24khz', choices=MODEL_NAMES)
    parser.add_argument('-c', '--checkpoint', default=None,
                        help='Released-layout or trainer checkpoint (the weights: there is '
                             'no download).')
    parser.add_argument('--seconds', type=float, nargs='+', default=[1.0],
                        help='Clip lengths to export (each is one static-shape entry; the '
                             'batch stays dynamic).')
    parser.add_argument('--bandwidths', type=float, nargs='+', default=None,
                        help="Bandwidths to export (default: the model's current bandwidth, "
                             'else its highest: ONE entry set; list every bandwidth you '
                             'serve).')
    parser.add_argument('--weights', default='raw', choices=['raw', 'fold'],
                        help="'fold' bakes folded weight-norm kernels (bit-equal, fewer ops; "
                             'weight_norm models only).')
    parser.add_argument('--platforms', nargs='+', default=['cpu', 'cuda'],
                        choices=['cpu', 'cuda'],
                        help='Platforms recorded in the artifact.')
    parser.add_argument('--kinds', nargs='+', default=['encode', 'decode', 'roundtrip'],
                        choices=['encode', 'decode', 'roundtrip'],
                        help='Entry kinds to export. Weights are baked per entry, so dropping '
                             'roundtrip (the loader composes encode+decode instead) shrinks '
                             'the artifact by about a third.')
    parser.add_argument('--device', default='cuda',
                        help="Where the export traces the model: 'cuda' (default), 'cuda:N' "
                             "or 'cpu'.")
    parser.add_argument('-f', '--force', action='store_true',
                        help='Overwrite the output file.')
    return parser


def fatal(msg: str):
    print(msg, file=sys.stderr)
    sys.exit(1)


def main(argv=None):
    args = get_parser().parse_args(argv)
    if os.path.exists(args.output) and not args.force:
        fatal(f'{args.output} exists. Use -f to overwrite.')
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        fatal('CUDA is not available; pass --device cpu to export on the CPU')
    if not args.checkpoint:
        fatal(f'{args.model_name} needs weights: pass -c/--checkpoint (no network access '
              'for downloads)')

    from .models.model import MODELS
    # the codec CLI's loading rules: the trainer-checkpoint factories take the
    # path positionally, the released ones a released-layout state dict
    if args.model_name in ('my_encodec', 'encodec_bw'):
        model = MODELS[args.model_name](args.checkpoint, device=device)
    else:
        model = MODELS[args.model_name](checkpoint=args.checkpoint, device=device)

    if args.weights == 'fold':
        from .prepare import fold_weight_norm
        try:
            model = fold_weight_norm(model)
        except ValueError as e:
            fatal(f'--weights fold: {e}')

    bandwidths = args.bandwidths
    if bandwidths is not None:
        bad = [b for b in bandwidths if b not in model.target_bandwidths]
        if bad:
            fatal(f'unsupported bandwidths {bad}; {args.model_name} serves '
                  f'{model.target_bandwidths}')

    lengths = [int(round(s * model.sample_rate)) for s in args.seconds]
    from .deploy import save_artifact
    meta = save_artifact(args.output, model, lengths, bandwidths, platforms=args.platforms,
                         kinds=args.kinds)
    size = os.path.getsize(args.output)
    print(f"wrote {args.output}: {len(meta['entries'])} entries ({len(lengths)} lengths x "
          f"{len(bandwidths) if bandwidths else 'default'} bandwidths x "
          f"{'/'.join(args.kinds)}), {size / 1e6:.1f} MB, platforms={meta['platforms']}")
    return meta


if __name__ == '__main__':
    main()
