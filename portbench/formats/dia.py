"""``dia``: the pencil in the program's DIA storage (`ops.dia.dia_pencil`),
so that every sparse product runs kernel K1."""


def operators(config: dict, inputs: dict, dtype, device):
    from differentialriccatiequations_jl_tpu_torch.ops.dia import dia_pencil

    return dia_pencil(inputs["E"], inputs["A"], dtype=dtype, device=device)
