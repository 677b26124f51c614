"""Reference-checkpoint converter CLI.

    python -m languagegroundedsemseg_torch.cli.convert \
        --ckpt Res16UNet34C.pth --model Res16UNet34C --out-channels 200 \
        --out converted.ckpt

Counterpart of ``languagegroundedsemseg_tpu/cli/convert.py`` (:1-70), with
the same arguments. Imports a reference Model Zoo checkpoint (reference
README.md:144-149) into the port's state dict — lenient shape-matched
loading (reference lib/utils.py:17-45) and the ME->canonical kernel-slot
permutation (train/checkpoints.py:me_kernel_permutation) — and saves
``{"model": state_dict}`` with ``torch.save``. The output loads through
``--weights`` (``Trainer._maybe_load_weights``) with ``weights_only=True``.
The model is built on ``device`` (the card unless the caller asks for the
CPU) and the file holds CPU tensors.
"""

from __future__ import annotations

import argparse


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True, help="torch .pth/.ckpt state dict")
    ap.add_argument("--model", default="Res16UNet34C")
    ap.add_argument("--out-channels", type=int, default=200)
    ap.add_argument("--in-channels", type=int, default=3)
    ap.add_argument("--out", required=True, help="output port checkpoint path")
    ap.add_argument("--no-kernel-perm", action="store_true",
                    help="skip the ME->canonical kernel-slot permutation")
    args = ap.parse_args(argv)

    import torch

    from languagegroundedsemseg_torch.models import load_model
    from languagegroundedsemseg_torch.train.checkpoints import (
        load_torch_state_dict,
        torch_to_port_state_dict,
    )

    model = load_model(args.model)(in_channels=args.in_channels,
                                   out_channels=args.out_channels,
                                   device=device)
    sd = load_torch_state_dict(args.ckpt)
    merged, skipped = torch_to_port_state_dict(
        sd, model.state_dict(), kernel_perm=None if args.no_kernel_perm else "me")
    model.load_state_dict(merged)
    print(f"mapped {len(sd) - len(skipped)}/{len(sd)} tensors; skipped:")
    for s in skipped:
        print(f"  {s}")
    blob = {"model": {k: v.cpu() for k, v in model.state_dict().items()}}
    torch.save(blob, args.out)
    n_bytes = sum(v.numel() * v.element_size() for v in blob["model"].values())
    print(f"wrote {args.out} ({n_bytes / 1e6:.1f} MB)")
    return merged, skipped


if __name__ == "__main__":
    main()
