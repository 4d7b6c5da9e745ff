"""Model FLOPs of an iteration (``flops/<config>.py``, counted from the
networks' shapes) over an untraced iteration's wall seconds in the same run
and the card's fp32 peak outside the tensor cores (67 TFLOP/s: the port's
fp32 configs run with TF32 off), in %. Moves ``env_steps_per_s``."""


def read(s):
    if not s.flops_per_iter or not s.peak_flops or not s.untraced_s_per_iter:
        return None
    return 100.0 * s.flops_per_iter / s.untraced_s_per_iter / s.peak_flops
