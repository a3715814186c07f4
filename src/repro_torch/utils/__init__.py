from repro_torch.utils.tree import ParamBuilder, fan_in_init, zeros_init
