"""The program's entry op of each kind, one module per kind.

Every module gives ``call(port, x, params)``: the timed call into the
program (``port`` is the imported ``gpu_fft_tpu_torch``, looked up at each
call), returning the outputs that ``reference/<kind>.py`` judges.
"""
