"""Float32 convolutions of the port's UNet run in full float32.

cuDNN's default (torch.backends.cudnn.allow_tf32 = True) runs float32
convolutions in TF32 on the card, about 1e-3 relative, against the JAX
reference's exact float32. Conv and ConvTranspose pin TF32 off around their
float32 calls and restore the caller's setting; bf16 calls leave it alone.
The flag is recorded at the call on the CPU, where cuDNN is not used, so
this checks what the card would be asked for.
"""

import pytest
import torch
import torch.nn.functional as F

from pdunet_tpu_torch.models.unet import Conv, ConvTranspose

torch.set_num_threads(1)


@pytest.mark.parametrize("layer,fn", [(Conv, "conv2d"), (ConvTranspose, "conv_transpose2d")],
                         ids=["Conv", "ConvTranspose"])
@pytest.mark.parametrize("dtype,allowed", [(torch.float32, False), (torch.bfloat16, True)],
                         ids=["f32", "bf16"])
def test_f32_convs_pin_tf32_off(monkeypatch, layer, fn, dtype, allowed):
    seen = []
    real = getattr(F, fn)

    def record(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real(*args, **kwargs)

    monkeypatch.setattr(F, fn, record)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    gen = torch.Generator().manual_seed(0)
    mod = (layer(4, 8, 3, dtype=dtype, generator=gen) if layer is Conv
           else layer(4, 8, dtype=dtype, generator=gen))
    out = mod(torch.randn(1, 4, 8, 8, generator=gen))
    assert seen == [allowed]
    assert torch.backends.cudnn.allow_tf32 is True  # the caller's setting is back
    assert out.dtype == dtype
