"""face_pairing_s: host seconds of the solver's face pairing at set-up,
the program's own span setup.faces (mesh/core.build_faces: the interior
faces matched by hash, the cyclic faces by centroid offset)."""

from bench_h100.program_trace import program_record, setup_seconds


def read(rec):
    return setup_seconds(program_record(), "setup.faces")
