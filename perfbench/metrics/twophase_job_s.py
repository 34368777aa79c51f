"""Seconds of one whole §VI job (insert phase, freeze, regular phase): the
window, from its start to the completion on the device of its last job,
over the jobs it ran."""


def read(rec):
    return rec.twophase_job_s
