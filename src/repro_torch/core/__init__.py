"""Core math of the port: the peephole LSTM with its hand-written training
backward (``lstm``), the CTC loss and greedy decoding (``ctc``), the
silicon's fixed-point formats and LUTs (``quant``) and the single-device
systolic datapath, float and bit-exact int8 (``systolic``)."""
