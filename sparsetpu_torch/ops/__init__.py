"""Operations of the port: the chain router, sorted-segment primitives, ESC SpGEMM."""
