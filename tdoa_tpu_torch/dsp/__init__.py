"""Signal-analysis helpers (torch and numpy): windows, FIR filtering and
decimation (``filters.py``), FM/AM/SSB demodulation (``fm.py``), the
in-peak multipath detector and echo-bias accounting (``multipath.py``),
and the Welch PSD and percentile-split SNR (``snr.py``)."""
