from tdoa_tpu_torch.io.datfile import (
    DatCapture,
    iq_to_bytes,
    load_dat,
    save_dat,
    split_blocks,
)
from tdoa_tpu_torch.io.wav import read_wav, write_wav
from tdoa_tpu_torch.io.stations import (
    Station,
    StationTable,
    load_station_table,
    station_from_filename,
)

__all__ = [
    "DatCapture",
    "iq_to_bytes",
    "load_dat",
    "save_dat",
    "split_blocks",
    "Station",
    "StationTable",
    "load_station_table",
    "station_from_filename",
    "read_wav",
    "write_wav",
]
