"""Frozen counters of the work a cell needs: FLOPs by ``torch``'s
``FlopCounterMode`` over the plain reference on the meta device (nothing is
computed), and the bytes of the resample ops from their shapes. They read
the configuration, never what the program launches, so a later change to
the program's kernels leaves the counts alone."""
