from .fast_csv import load_numeric_csv, native_available
from .datasets import CSV_HEADER, load_gp_dataset, load_gp_datasets, save_gp_dataset
from .checkpoint import (
    load_gp_checkpoint,
    load_resume_state,
    save_gp_checkpoint,
    save_resume_state,
)
from .flight_log import analyze_flight_log, load_flight_log, save_flight_log
from .sklearn_import import (
    load_reference_gp,
    load_sklearn_gp_pickle,
    load_sklearn_perdim_pickle,
)
from .synthetic import (
    CORPUS_ROWS,
    generate_excitation_data,
    identify_linear_dynamics,
    synthetic_corpus,
)
from .uavlog import UavLogWriter, read_uavlog, write_uavlog

__all__ = [
    "CSV_HEADER",
    "load_numeric_csv",
    "native_available",
    "load_gp_dataset",
    "load_gp_datasets",
    "save_gp_dataset",
    "load_gp_checkpoint",
    "save_gp_checkpoint",
    "load_resume_state",
    "save_resume_state",
    "analyze_flight_log",
    "load_flight_log",
    "save_flight_log",
    "load_reference_gp",
    "load_sklearn_gp_pickle",
    "load_sklearn_perdim_pickle",
    "CORPUS_ROWS",
    "generate_excitation_data",
    "synthetic_corpus",
    "identify_linear_dynamics",
    "UavLogWriter",
    "read_uavlog",
    "write_uavlog",
]
