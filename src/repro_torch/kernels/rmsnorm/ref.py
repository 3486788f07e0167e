"""Plain PyTorch version of the RMSNorm kernel (the port of the JAX
package's oracle `repro/kernels/rmsnorm/ref.py`)."""
import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
