"""Signal-analysis helpers (torch and numpy): windows, FIR filtering and
decimation (``filters.py``), FM/AM/SSB demodulation (``fm.py``), and the
in-peak multipath detector and echo-bias accounting (``multipath.py``)."""
