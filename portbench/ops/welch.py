"""``welch_device`` on (C, L) real rows: the one-sided PSD of each channel."""


def call(port, x, params):
    _, psd = port.welch_device(
        x, fs=params.get("fs", 1.0), window=params.get("window", "hann"),
        nperseg=params["nperseg"], noverlap=params["noverlap"],
        detrend=params.get("detrend", "constant"), scaling=params.get("scaling", "density"),
        average=params.get("average", "mean"))
    return psd
