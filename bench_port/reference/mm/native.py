"""Stand-in for mm2_gb_tpu_torch/utils/native.py in the frozen copies: the
reference has no C++ host kit, so every copy takes its NumPy branch."""


def available() -> bool:
    return False
