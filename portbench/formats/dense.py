"""``dense``: the pencil as the program's dense operators (`DenseOp`) on the
device, built from the generator's matrices, so that every product and
solve runs on cuBLAS and cuSOLVER."""

import torch


def operators(config: dict, inputs: dict, dtype, device):
    from differentialriccatiequations_jl_tpu_torch.ops.operators import DenseOp

    return tuple(DenseOp(torch.as_tensor(inputs[k].toarray(), dtype=dtype, device=device))
                 for k in "EA")
