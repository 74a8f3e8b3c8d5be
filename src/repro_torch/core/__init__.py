"""Core math of the port, forward / inference only: the peephole LSTM
(``lstm``), greedy CTC decoding (``ctc``), the silicon's fixed-point formats
and LUTs (``quant``) and the single-device systolic datapath, float and
bit-exact int8 (``systolic``)."""
