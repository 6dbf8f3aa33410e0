"""``fft_device`` on (B, n) real rows: the full split-complex spectrum."""


def call(port, x, params):
    return port.fft_device(x)
