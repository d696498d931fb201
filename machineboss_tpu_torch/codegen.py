"""Code generation entry point (ref: src/compiler.{h,cpp}).

Emits specialized Forward/Viterbi source for a fixed machine. Targets:
C++ (32/64-bit int-log), JavaScript, WGSL. Dispatches to codegen_impl.
"""


def run_codegen(machine, vm):
    from .codegen_impl import (CPlusPlusCompiler, JavaScriptCompiler,
                               compile_wgsl, seq_type_for)
    n_targets = sum(1 for k in ("--cpp32", "--cpp64", "--js", "--wgsl")
                    if k in vm)
    if n_targets > 1:
        raise ValueError("Options --cpp32, --cpp64, --js, and --wgsl are"
                         " mutually incompatible; choose a target language")
    out_dir = vm["--codegen"]
    if "--wgsl" in vm:
        compile_wgsl(machine, out_dir)
        return
    if "--js" in vm:
        compiler = JavaScriptCompiler()
    else:
        compiler = CPlusPlusCompiler(is_64bit="--cpp64" in vm)
    compiler.show_cells = "--showcells" in vm
    compiler.use_max_reduce = "--compileviterbi" in vm
    x_type = seq_type_for(vm.get("--inseq"), machine.input_alphabet())
    y_type = seq_type_for(vm.get("--outseq"), machine.output_alphabet())
    compiler.compile_forward(machine, x_type, y_type, out_dir)
