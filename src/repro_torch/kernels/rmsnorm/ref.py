"""Plain PyTorch version of the RMSNorm kernel (the port of the JAX
package's oracle `repro/kernels/rmsnorm/ref.py`).

The mean of squares is summed in float64 and rounded to float32 once, as
the kernel does (`csrc/rmsnorm.cu`): the result then does not depend on
the order of the sum, so the two agree bit for bit. The oracle sums in
float32; the float32 mean differs from its by at most an ulp.
"""
import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    xd = xf.double()
    var = torch.mean(xd * xd, dim=-1, keepdim=True).float()
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
