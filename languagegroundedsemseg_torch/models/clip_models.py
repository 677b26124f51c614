"""CLIP-space model variants for language-grounded pretraining.

Counterpart of ``languagegroundedsemseg_tpu/models/clip_models.py``, the
variants that are only class attributes over ``Res16UNetBase``:
- Res16UNet34CR (reference models/clip_models.py:95-188): 34C whose
  block8 last relu is stripped; under representation_only the classifier
  is skipped and raw features are the output (in the anchor space).
- Res16UNet34D (:205-215): CLIP-dimensional variant, PLANES[-1] = 512, the
  model of the reference's language-grounded pretraining
  (scripts/text_representation_train.sh).
The variants with modules of their own (the anchor projection, the paired
SimSiam forward, the deeper heads) come with the rest of the model zoo.
"""

from __future__ import annotations

from typing import Tuple

from languagegroundedsemseg_torch.models.res16unet import Res16UNet34C


class Res16UNet34CR(Res16UNet34C):
    STRIP_FINAL_RELU: bool = True


class Res16UNet34D(Res16UNet34CR):
    PLANES: Tuple[int, ...] = (32, 64, 128, 256, 256, 256, 256, 512)
