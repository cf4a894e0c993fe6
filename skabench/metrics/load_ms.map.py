"""load_ms.map: map's .skf load (io/skf.py, io/cbor.py, io/snappy.py,
csrc/host/skanative.cpp): the whole span ska::load, its steps ska::read,
ska::decompress and ska::decode included, ms per job."""


def read(trace, run):
    names = ('ska::load',)
    if not trace.named(names) or not run["jobs"]:
        return None
    return 1e3 * trace.self_s(names, ()) / run["jobs"]
