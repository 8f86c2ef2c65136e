"""Model registry: ConfigType enum + per-model default configs.

Equivalent of reference ``utils/model.py::ConfigType`` / ``_configs`` /
``find_model`` / ``find_config``. A copy of ``honk_tpu.models.registry``
(tests hold ``find_config`` equal for its 16 types) whose ``find_model``
returns the port's ``nn.Module`` classes, with a 17th type the port alone
has: ``kwt-3``, the Keyword Transformer (Berg, O'Connor & Cruz,
Interspeech 2021, arXiv:2104.00769, Table 1; ``models/kwt.py``), whose
``"recipe": "adamw"`` names the optimizer the training loop builds for it
(``train.state.make_adamw``).

PROVENANCE: the reference mount was empty at survey time (SURVEY.md §0);
the geometry below is reconstructed from the upstream Honk codebase
(castorini/honk, Tang & Lin 2017) and its governing papers — Sainath &
Parada, Interspeech 2015 ("Convolutional Neural Networks for
Small-footprint Keyword Spotting") for the cnn-* family, and Tang & Lin,
ICASSP 2018 ("Deep Residual Learning for Small-Footprint Keyword
Spotting") for the res-* family. Parameter-count sanity checks for the
res family match the paper's Table 1 (res8 ~110k, res15 ~238k,
res26 ~438k params).
"""

from __future__ import annotations

import enum
from typing import Any


class ConfigType(enum.Enum):
    CNN_TRAD_POOL2 = "cnn-trad-pool2"
    CNN_ONE_STRIDE1 = "cnn-one-stride1"
    CNN_ONE_FPOOL3 = "cnn-one-fpool3"
    CNN_ONE_FSTRIDE4 = "cnn-one-fstride4"
    CNN_ONE_FSTRIDE8 = "cnn-one-fstride8"
    CNN_TPOOL2 = "cnn-tpool2"
    CNN_TPOOL3 = "cnn-tpool3"
    CNN_TSTRIDE2 = "cnn-tstride2"
    CNN_TSTRIDE4 = "cnn-tstride4"
    CNN_TSTRIDE8 = "cnn-tstride8"
    RES15 = "res15"
    RES26 = "res26"
    RES8 = "res8"
    RES15_NARROW = "res15-narrow"
    RES8_NARROW = "res8-narrow"
    RES26_NARROW = "res26-narrow"
    KWT3 = "kwt-3"


# Input feature geometry: (time=101 frames, freq=40 MFCCs) for 1 s audio.
_BASE_CNN = dict(dropout_prob=0.5, height=101, width=40, n_labels=12)

_configs: dict[ConfigType, dict[str, Any]] = {
    # TF-tutorial variant of Sainath & Parada's trad model (conv 20x8x64 ->
    # maxpool 2x2 -> conv 10x4x64 -> fc). tf_variant matches the TF Speech
    # Commands reference numerics (truncated-normal 0.01 init, zero bias).
    ConfigType.CNN_TRAD_POOL2: dict(
        _BASE_CNN,
        n_feature_maps1=64,
        conv1_size=(20, 8),
        conv1_pool=(2, 2),
        conv1_stride=(1, 1),
        n_feature_maps2=64,
        conv2_size=(10, 4),
        conv2_stride=(1, 1),
        conv2_pool=(1, 1),
        tf_variant=True,
    ),
    ConfigType.CNN_ONE_STRIDE1: dict(
        _BASE_CNN,
        n_feature_maps1=186,
        conv1_size=(101, 8),
        conv1_pool=(1, 1),
        conv1_stride=(1, 1),
        dnn1_size=128,
        dnn2_size=128,
        tf_variant=True,
    ),
    ConfigType.CNN_ONE_FPOOL3: dict(
        _BASE_CNN,
        n_feature_maps1=54,
        conv1_size=(101, 8),
        conv1_pool=(1, 3),
        conv1_stride=(1, 1),
        dnn1_size=128,
        dnn2_size=128,
    ),
    ConfigType.CNN_ONE_FSTRIDE4: dict(
        _BASE_CNN,
        n_feature_maps1=186,
        conv1_size=(101, 8),
        conv1_pool=(1, 1),
        conv1_stride=(1, 4),
        dnn1_size=128,
        dnn2_size=128,
    ),
    ConfigType.CNN_ONE_FSTRIDE8: dict(
        _BASE_CNN,
        n_feature_maps1=336,
        conv1_size=(101, 8),
        conv1_pool=(1, 1),
        conv1_stride=(1, 8),
        dnn1_size=128,
        dnn2_size=128,
    ),
    ConfigType.CNN_TPOOL2: dict(
        _BASE_CNN,
        n_feature_maps1=94,
        n_feature_maps2=94,
        conv1_size=(21, 8),
        conv2_size=(6, 4),
        conv1_pool=(2, 3),
        conv1_stride=(1, 1),
        conv2_stride=(1, 1),
        conv2_pool=(1, 1),
        dnn1_size=128,
        dnn2_size=128,
    ),
    ConfigType.CNN_TPOOL3: dict(
        _BASE_CNN,
        n_feature_maps1=94,
        n_feature_maps2=94,
        conv1_size=(15, 8),
        conv2_size=(6, 4),
        conv1_pool=(3, 3),
        conv1_stride=(1, 1),
        conv2_stride=(1, 1),
        conv2_pool=(1, 1),
        dnn1_size=128,
        dnn2_size=128,
    ),
    ConfigType.CNN_TSTRIDE2: dict(
        _BASE_CNN,
        n_feature_maps1=78,
        n_feature_maps2=78,
        conv1_size=(16, 8),
        conv2_size=(9, 4),
        conv1_pool=(1, 3),
        conv1_stride=(2, 1),
        conv2_stride=(1, 1),
        conv2_pool=(1, 1),
        dnn1_size=128,
        dnn2_size=128,
    ),
    ConfigType.CNN_TSTRIDE4: dict(
        _BASE_CNN,
        n_feature_maps1=100,
        n_feature_maps2=78,
        conv1_size=(16, 8),
        conv2_size=(5, 4),
        conv1_pool=(1, 3),
        conv1_stride=(4, 1),
        conv2_stride=(1, 1),
        conv2_pool=(1, 1),
        dnn1_size=128,
        dnn2_size=128,
    ),
    ConfigType.CNN_TSTRIDE8: dict(
        _BASE_CNN,
        n_feature_maps1=126,
        n_feature_maps2=78,
        conv1_size=(16, 8),
        conv2_size=(5, 4),
        conv1_pool=(1, 3),
        conv1_stride=(8, 1),
        conv2_stride=(1, 1),
        conv2_pool=(1, 1),
        dnn1_size=128,
        dnn2_size=128,
    ),
    # Residual family (Tang & Lin, ICASSP 2018). conv0 3x3 bias-free, then
    # n_layers 3x3 bias-free convs with identity residual every 2 layers and
    # per-layer affine-free BatchNorm; res8/res26 average-pool after conv0;
    # res15 uses dilation 2^((i-1)//3) on layer i (models/res.py).
    ConfigType.RES8: dict(
        n_labels=12, n_layers=6, n_feature_maps=45, res_pool=(4, 3), use_dilation=False
    ),
    ConfigType.RES8_NARROW: dict(
        n_labels=12, n_layers=6, n_feature_maps=19, res_pool=(4, 3), use_dilation=False
    ),
    ConfigType.RES15: dict(n_labels=12, n_layers=13, n_feature_maps=45, use_dilation=True),
    ConfigType.RES15_NARROW: dict(
        n_labels=12, n_layers=13, n_feature_maps=19, use_dilation=True
    ),
    ConfigType.RES26: dict(
        n_labels=12, n_layers=24, n_feature_maps=45, res_pool=(2, 2), use_dilation=False
    ),
    ConfigType.RES26_NARROW: dict(
        n_labels=12, n_layers=24, n_feature_maps=19, res_pool=(2, 2), use_dilation=False
    ),
    # KWT-3: a token a MFCC frame (101 of 40 coefficients) and a class token, 12 PostNorm blocks at d=192,
    # 3 heads of 64, an MLP of 768; trained with AdamW, warm-up and cosine decay, label smoothing 0.1.
    ConfigType.KWT3: dict(
        n_labels=12, n_mfcc=40, frames=101, dim=192, depth=12, heads=3, head_dim=64, mlp_dim=768, recipe="adamw"
    ),
}


def find_config(conf: ConfigType | str) -> dict[str, Any]:
    """Default config dict for a model type (copy; safe to mutate)."""
    if isinstance(conf, str):
        conf = ConfigType(conf)
    return dict(_configs[conf])


def find_model(conf: ConfigType | str):
    """The ``nn.Module`` class for a model type: ``SpeechModel`` for cnn-*,
    ``SpeechResModel`` for res*, ``KeywordTransformer`` for kwt-*; each is
    built as ``cls(config, dtype=None)``."""
    from .cnn import SpeechModel
    from .kwt import KeywordTransformer
    from .res import SpeechResModel

    if isinstance(conf, str):
        conf = ConfigType(conf)
    if conf.value.startswith("kwt"):
        return KeywordTransformer
    return SpeechResModel if conf.value.startswith("res") else SpeechModel
