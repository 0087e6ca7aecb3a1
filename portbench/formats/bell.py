"""``bell``: the pencil in the program's block-ELL storage with the
configuration's block size ``bs`` (`ops.sparse.bell_pencil`), so that every
sparse product runs kernel K2."""


def operators(config: dict, inputs: dict, dtype, device):
    from differentialriccatiequations_jl_tpu_torch.ops.sparse import bell_pencil

    return bell_pencil(inputs["E"], inputs["A"], bs=config["bs"], dtype=dtype, device=device)
