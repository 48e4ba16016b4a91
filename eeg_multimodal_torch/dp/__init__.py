"""DP-SGD: the RDP accountant (``accountant``) and the per-example gradient
step with clipping, Gaussian noise and Poisson sampling (``dpsgd``)."""
