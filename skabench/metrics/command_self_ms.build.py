"""command_self_ms.build: the build command's own work (cli.py, api.py):
self time of the span ska::command, that is the command outside its
steps' spans (ska::parse, ska::device_pass, ska::union, ska::save, ...),
ms per job."""


def read(trace, run):
    names = ('ska::command',)
    if not trace.named(names) or not run["jobs"]:
        return None
    return 1e3 * trace.self_s(names) / run["jobs"]
