"""command_self_ms.map: the map command's own work (cli.py, api.py):
self time of the span ska::command, that is the command outside its
steps' spans (ska::load, ska::parse, ska::scan, ska::lookup, ...), ms
per job."""


def read(trace, run):
    names = ('ska::command',)
    if not trace.named(names) or not run["jobs"]:
        return None
    return 1e3 * trace.self_s(names) / run["jobs"]
