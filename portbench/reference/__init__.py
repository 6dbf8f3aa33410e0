"""The plain reference of each op kind, in float64, computed in blocks.

Plain PyTorch only: no module here imports the program, and nothing here
takes anything the program made except the outputs it judges.  Every module
gives ``reference(x, params, precision)``, the op's result on the inputs the
benchmark made, and ``judge(out, ref)``, the numbers compared, by name.
"""
