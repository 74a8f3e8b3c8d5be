"""Models of the port: the paper's CTC LSTM (``chipmunk_net``)."""
