"""``fft2_device`` on (B, H, W) real images: the full split-complex 2-D spectrum."""


def call(port, x, params):
    return port.fft2_device(x)
