"""Speaker embedding models (WeSpeaker ResNet34, CAM++ D-TDNN)."""

from .campplus import (  # noqa: F401
    CampPlusSpeaker,
    campplus_fbank,
    campplus_forward,
    init_campplus_params,
)
from .campplus import config_tiny as campplus_config_tiny  # noqa: F401
from .model import WeSpeaker, init_wespeaker_params, wespeaker_forward  # noqa: F401
