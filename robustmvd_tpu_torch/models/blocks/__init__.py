from .dispnet import (  # noqa: F401
    ConvLReLU,
    DeconvLReLU,
    DispnetContextEncoder,
    DispnetCostvolumeEncoder,
    DispnetDecoder,
    DispnetEncoder,
    IConvBlock,
    LearnedFusion,
    PredBlock,
    relu_and_sigmoid,
)
