"""Core math of the port: the peephole LSTM (``lstm``) and greedy CTC
decoding (``ctc``), forward / inference only."""
