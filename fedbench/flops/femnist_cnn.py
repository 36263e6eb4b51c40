"""The FEMNIST CNN's products, counted from its layers' shapes: each 5x5
SAME convolution 2 k^2 C_in C_out a pixel, each dense layer 2 n_in n_out
a sample; 3 times the forward a trained sample, once an evaluated one."""


def forward_flops(cfg: dict) -> float:
    side = cfg["image_size"]
    conv = 2 * 25 * (1 * 32 * side * side + 32 * 64 * (side // 2) ** 2)
    widths = [(side // 4) ** 2 * 64] + [cfg["fc_width"]] * cfg["n_fc"] + [cfg["n_classes"]]
    return float(conv + sum(2 * a * b for a, b in zip(widths, widths[1:])))


def round_flops(cfg: dict, traffic: dict, n_params: int, n_trained: int) -> float:
    silos = traffic["silos"]
    trained = sum(n for n, _ in silos) * traffic["local_epochs"]
    evaluated = sum(n for _, n in silos)
    return forward_flops(cfg) * (3 * trained + evaluated)
