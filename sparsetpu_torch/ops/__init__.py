"""Operations of the port: sorted-segment primitives, the SpGEMM routes and
their router (``spgemm_auto``), SpMM, elementwise ops, and the chain router."""
