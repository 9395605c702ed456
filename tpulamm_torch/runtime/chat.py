"""Chat templating — llama_chat_apply_template parity (llama.cpp:13868-13966).

Copy of tpulamm.runtime.chat.

Supports the five template families the reference ships at b2430 — chatml,
llama2 (+ <<SYS>>/strip/space/bos-in-history variants), zephyr, monarch,
gemma — detected either from an explicit name or by sniffing the Jinja
template string stored in the GGUF `tokenizer.chat_template` metadata,
exactly as the reference does. Unknown templates fall back to chatml (the
reference server's default).
"""

from __future__ import annotations


def apply_chat_template(tmpl: str, messages: list[dict],
                        add_assistant: bool = True) -> str:
    out: list[str] = []
    if tmpl == "chatml" or "<|im_start|>" in tmpl:
        for m in messages:
            out.append(f"<|im_start|>{m.get('role', 'user')}\n"
                       f"{m.get('content', '')}<|im_end|>\n")
        if add_assistant:
            out.append("<|im_start|>assistant\n")
    elif tmpl == "llama2" or "[INST]" in tmpl:
        support_sys = "<<SYS>>" in tmpl
        space_resp = "' ' + eos_token" in tmpl
        bos_history = "bos_token + '[INST]" in tmpl
        strip_msg = "content.strip()" in tmpl
        inside = True
        out.append("[INST] ")
        for m in messages:
            content = m.get("content", "")
            if strip_msg:
                content = content.strip()
            role = m.get("role", "user")
            if not inside:
                inside = True
                out.append("<s>[INST] " if bos_history else "[INST] ")
            if role == "system":
                if support_sys:
                    out.append(f"<<SYS>>\n{content}\n<</SYS>>\n\n")
                else:
                    out.append(content + "\n")
            elif role == "user":
                out.append(content + " [/INST]")
            else:
                sp = " " if space_resp else ""
                out.append(f"{sp}{content}{sp}</s>")
                inside = False
    elif tmpl == "zephyr" or "<|user|>" in tmpl:
        for m in messages:
            out.append(f"<|{m.get('role', 'user')}|>\n"
                       f"{m.get('content', '')}<|endoftext|>\n")
        if add_assistant:
            out.append("<|assistant|>\n")
    elif tmpl == "monarch" or "bos_token + message['role']" in tmpl:
        for i, m in enumerate(messages):
            bos = "" if i == 0 else "<s>"
            out.append(f"{bos}{m.get('role', 'user')}\n"
                       f"{m.get('content', '')}</s>\n")
        if add_assistant:
            out.append("<s>assistant\n")
    elif tmpl == "gemma" or "<start_of_turn>" in tmpl:
        system = ""
        for m in messages:
            role = m.get("role", "user")
            if role == "system":
                system = m.get("content", "").strip()
                continue
            role = "model" if role == "assistant" else role
            out.append(f"<start_of_turn>{role}\n")
            if system and role != "model":
                out.append(system + "\n\n")
                system = ""
            out.append(m.get("content", "").strip() + "<end_of_turn>\n")
        if add_assistant:
            out.append("<start_of_turn>model\n")
    else:
        # unsupported template -> chatml default (server.cpp behavior)
        return apply_chat_template("chatml", messages, add_assistant)
    return "".join(out)


def template_from_metadata(md: dict) -> str:
    """Model-embedded template, chatml when absent (llama.cpp:13957)."""
    return str(md.get("tokenizer.chat_template", "chatml"))
