from pdunet_tpu_torch.models.convert import flax_to_torch, load_flax_convnet, load_flax_unet
from pdunet_tpu_torch.models.primal_dual import ConvNet, UnrolledPrimalDual, make_lpd, make_pdunet
from pdunet_tpu_torch.models.unet import UNet

__all__ = ["ConvNet", "UNet", "UnrolledPrimalDual", "flax_to_torch", "load_flax_convnet",
           "load_flax_unet", "make_lpd", "make_pdunet"]
